"""heif_tpu — a HEIF/HEVC still-image decode engine on JAX.

A from-scratch JAX/XLA + C++-host framework with the capabilities of the
reference decoder (friendlymatthew/heif): ISOBMFF container parsing, HEVC
parameter-set / slice-header / CABAC entropy decoding — plus the pixel
reconstruction stack the reference leaves unimplemented (coding quadtree,
residual decode, inverse transforms, intra prediction, deblocking, SAO),
executed on the accelerator (an NVIDIA GPU) and sharded over device meshes.

Layering (host → device):
  container/  ISOBMFF box tree, item table, grid layout        (host)
  hevc/       NAL, RBSP bit reader, VPS/SPS/PPS, slice header  (host)
  cabac/      arithmetic engine, context models, syntax decode (host oracle)
  native/     C++ fast path for the entropy layers             (host, ctypes)
  ops/        dequant, IDCT/IDST, intra pred, deblock, SAO     (device: JAX/XLA)
  parallel/   tile sharding over jax.sharding.Mesh             (device mesh)
  models/     assembled decode pipelines (grid / single image) (orchestration)

Public API mirrors the reference crate's re-exports (src/lib.rs:10-11):
`HeifReader` for container access, `HeicDecoder` for the full pipeline.
"""

import os

# the checkout root (the directory holding the package)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JIT_CACHE_DIR = os.path.join(_ROOT, ".jax_cache")


def _in_checkout() -> bool:
    """True when the package runs from a source checkout (pyproject.toml
    beside it), False for an installed copy (e.g. in site-packages)."""
    return os.path.isfile(os.path.join(_ROOT, "pyproject.toml"))


def _enable_jit_cache() -> None:
    """Persistent XLA compilation cache: the decode programs are identical
    across processes, so the first process compiles and later ones load.
    JAX_COMPILATION_CACHE_DIR, when set, names the directory; otherwise a
    checkout uses JIT_CACHE_DIR, fixed inside it (a cache directory that
    moves never hits), and an installed copy sets no cache."""
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        if not _in_checkout():
            return
        cache = JIT_CACHE_DIR
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


_enable_jit_cache()

from heif_tpu.container.reader import HeifReader
from heif_tpu.models.decoder import HeicDecoder

__all__ = ["HeifReader", "HeicDecoder"]
__version__ = "0.1.0"
