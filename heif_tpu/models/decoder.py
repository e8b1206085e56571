"""HeicDecoder — the top-level decode pipeline orchestrator.

Parity target: reference src/heic/decoder.rs:12-131 (container parse →
hvcC → VPS/SPS/PPS → grid dispatch → per-tile slice decode), extended with
the full reconstruction stack the reference stubs out
(src/hevc/slice.rs:249-255).

Two reconstruction backends share the SyntaxTensors contract:
  - "ref": numpy host reference (bit-exact oracle twin)
  - "jax": device pipeline (heif_tpu.ops.jax_recon), default when available
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from heif_tpu.container import grammar as g
from heif_tpu.container.reader import HeifReader, parse_grid_config


@dataclass
class ImageInfo:
    """Resolved metadata for the primary picture (config 0 deliverable)."""

    ispe_width: int
    ispe_height: int
    display_width: int  # after irot
    display_height: int
    rotation: int  # irot angle, multiples of 90 deg CCW
    luma_bit_depth: int
    chroma_bit_depth: int
    chroma_format_idc: int
    grid: Optional[g.GridConfig]
    tile_ids: list[int]
    primary_item_id: int
    thumbnail_count: int
    icc: Optional[object] = None  # container.icc.IccProfile when present


@dataclass
class FrontEnd:
    """What the host front end (HeicDecoder.front_end) hands the
    reconstruction: parameter sets, the decodable tiles' slices and
    entropy-decoded syntax, and the layout that stitches the tiles."""

    info: ImageInfo
    sps: object
    pps: object
    grid: g.GridConfig
    tile_ids: list[int]
    crop_off: tuple
    angle: int  # irot of the decoded item
    hints: dict  # ops.batch.schedule_hints
    slices: list  # decodable tiles only
    syntaxes: list  # SyntaxTensors, one per entry of slices
    bad: dict  # tile index -> the exception that made it undecodable


def _jax_usable() -> bool:
    """True when a jax backend initializes (any platform; the jitted
    pipeline runs on the CPU too, just slower than on a GPU)."""
    try:
        import jax

        return len(jax.devices()) > 0
    except Exception:
        return False


def _select_vcl_nal(nals: list[bytes]) -> bytes:
    """Pick THE slice NAL of an hvc1 item.

    Items may legally carry non-VCL NALs (SEI, parameter sets) alongside
    the slice; more than one VCL NAL would mean a multi-slice picture,
    which this decoder (like the reference, src/heic/decoder.rs:152-157)
    rejects loudly rather than silently decoding only the first.
    """
    vcl = [n for n in nals if ((n[0] >> 1) & 0x3F) <= 31]
    if not vcl:
        raise ValueError("item contains no VCL (slice) NAL unit")
    if len(vcl) > 1:
        raise ValueError(
            f"item contains {len(vcl)} VCL NAL units; multi-slice items "
            "are not supported"
        )
    return vcl[0]


class HeicDecoder:
    """End-to-end HEIC decode: container → entropy → device reconstruction."""

    @staticmethod
    def probe(data: bytes) -> ImageInfo:
        """Parse container metadata only (no entropy/pixel work).

        Mirrors what the reference can do today plus grid-config resolution
        (which requires idat support, reference's todo! at
        src/heif/reader.rs:42).
        """
        reader = HeifReader(data)
        heif = reader.read()
        primary = heif.primary_item_id()
        info = heif.item_info_by_item_id(primary)
        if info is None:
            raise ValueError(f"primary item {primary} missing from iinf")

        props = heif.meta.item_properties
        ispe = props.property_of_type(primary, g.ImageSpatialExtentsProperty)
        if ispe is None:
            raise ValueError("primary item has no ispe property")
        irot = props.property_of_type(primary, g.ImageRotationProperty)
        angle = irot.angle if irot else 0
        if angle in (1, 3):
            disp_w, disp_h = ispe.height, ispe.width
        else:
            disp_w, disp_h = ispe.width, ispe.height

        grid = None
        tile_ids: list[int] = []
        if info.item_type == g.ItemType.GRID:
            grid = parse_grid_config(reader.get_item_data(primary))
            tile_ids = heif.item_ids_referencing(primary, "dimg")

        hvcc = heif.hevc_configuration_record(
            tile_ids[0] if tile_ids else primary
        )
        if hvcc is None:
            raise ValueError("no hvcC record found")

        thumbs = heif.items_referring_to(primary, "thmb")

        # ICC: parse header + tag table from a prof/rICC colr payload
        # (completes the reference's dead color module,
        # src/color/reader.rs:11-135)
        icc = None
        colr = props.property_of_type(
            tile_ids[0] if tile_ids else primary, g.ColorInformationProperty
        ) or props.property_of_type(primary, g.ColorInformationProperty)
        if colr is not None and colr.icc_profile:
            from heif_tpu.container.icc import parse_icc_header

            try:
                icc = parse_icc_header(colr.icc_profile)
            except ValueError:
                icc = None

        return ImageInfo(
            ispe_width=ispe.width,
            ispe_height=ispe.height,
            display_width=disp_w,
            display_height=disp_h,
            rotation=angle,
            luma_bit_depth=hvcc.bit_depth_luma_minus8 + 8,
            chroma_bit_depth=hvcc.bit_depth_chroma_minus8 + 8,
            chroma_format_idc=hvcc.chroma_format_idc,
            grid=grid,
            tile_ids=tile_ids,
            primary_item_id=primary,
            thumbnail_count=len(thumbs),
            icc=icc,
        )

    # ------------------------------------------------------------------
    # Full pixel decode
    # ------------------------------------------------------------------

    @staticmethod
    def front_end(
        data: bytes,
        item_id: Optional[int] = None,
        isolate_tile_errors: bool = False,
    ) -> FrontEnd:
        """The host half of decode(): container, parameter sets, slice
        headers and entropy decode of the primary (or given) item. Its
        slices and syntaxes are what the reconstruction backends take
        (e.g. ops.batch.plan_chunks builds the device batches from them).
        isolate_tile_errors: see decode()."""
        from heif_tpu import native
        from heif_tpu.cabac.syntax import TileSyntaxDecoder
        from heif_tpu.hevc import params
        from heif_tpu.hevc import slice as sl
        from heif_tpu.hevc.rbsp import remove_emulation_prevention
        from heif_tpu.ops.batch import schedule_hints

        reader = HeifReader(data)
        heif = reader.read()
        info = HeicDecoder.probe(data)
        target = item_id if item_id is not None else info.primary_item_id
        tgt_info = heif.item_info_by_item_id(target)
        if tgt_info is None:
            raise ValueError(f"item {target} not present in container")

        rec = heif.hevc_configuration_record(target)
        if rec is None:
            raise ValueError("no hvcC record")
        sps = params.parse_sps(
            remove_emulation_prevention(rec.nal_units_of_type(33)[0][2:])
        )
        pps = params.parse_pps(
            remove_emulation_prevention(rec.nal_units_of_type(34)[0][2:])
        )
        length_size = rec.length_size_minus_one + 1

        # crop + rotation come from the TARGET item's own properties (an
        # auxiliary item has its own ispe/irot, distinct from the
        # primary's — decoding item 52 of the sample with the primary's
        # irot produced a rotated, uncropped plane)
        props = heif.meta.item_properties
        irot_t = props.property_of_type(target, g.ImageRotationProperty)
        angle = irot_t.angle if irot_t else 0
        if tgt_info.item_type == g.ItemType.GRID:
            grid = parse_grid_config(reader.get_item_data(target))
            tile_ids = heif.item_ids_referencing(target, "dimg")
            crop_off = (0, 0)
        else:
            ispe_t = props.property_of_type(
                target, g.ImageSpatialExtentsProperty
            )
            # the crop ORIGIN always comes from the SPS conformance
            # window (§7.4.3.2.1): a window with nonzero left/top
            # offsets starts at (sub*left, sub*top) even when an ispe
            # property provides the output size. Sub-sampling factors
            # are 2 for 4:2:0, 1 for monochrome.
            sub = 2 if sps.chroma_format_idc == 1 else 1
            crop_off = (
                sub * sps.conf_win_left_offset,
                sub * sps.conf_win_top_offset,
            )
            if ispe_t is not None:
                out_w, out_h = ispe_t.width, ispe_t.height
            else:
                out_w = sps.pic_width_in_luma_samples - sub * (
                    sps.conf_win_left_offset + sps.conf_win_right_offset
                )
                out_h = sps.pic_height_in_luma_samples - sub * (
                    sps.conf_win_top_offset + sps.conf_win_bottom_offset
                )
            grid = g.GridConfig(
                rows=1, columns=1, output_width=out_w, output_height=out_h
            )
            tile_ids = [target]

        # entropy-decode every tile (host; native C++ path when available,
        # Python oracle otherwise). With isolate_tile_errors, header or
        # entropy corruption in one tile is captured instead of raised —
        # that tile decodes as mid-gray and the rest of the grid survives.
        slices = []
        bad: dict[int, Exception] = {}
        for ti, tid in enumerate(tile_ids):
            try:
                nals = sl.split_length_prefixed_nals(
                    reader.get_item_data(tid), length_size
                )
                slices.append(
                    sl.parse_slice_header(_select_vcl_nal(nals), sps, pps)
                )
            except Exception as e:
                if not isolate_tile_errors:
                    raise
                bad[ti] = e
                slices.append(None)
        if not any(ps is not None for ps in slices):
            raise ValueError("no decodable tiles")

        # scheduler hints from the stream's declared parallelism metadata
        # (hvcC parallelism_type / min_spatial_segmentation_idc)
        hints = schedule_hints(rec, sps, pps, len(tile_ids))

        def entropy(parsed):
            if native.available():
                return native.decode_tiles_parallel(
                    sps, pps, parsed,
                    max_workers=hints.get("entropy_workers"),
                )
            return [TileSyntaxDecoder(sps, pps, ps).decode() for ps in parsed]

        if isolate_tile_errors:
            syntaxes = []
            for ti, ps in enumerate(slices):
                if ps is None:
                    continue
                try:
                    syntaxes.extend(entropy([ps]))
                except Exception as e:
                    bad[ti] = e
                    slices[ti] = None
            slices = [ps for ps in slices if ps is not None]
        else:
            syntaxes = entropy(slices)
        if not slices:
            raise ValueError("no decodable tiles")
        return FrontEnd(
            info=info, sps=sps, pps=pps, grid=grid, tile_ids=tile_ids,
            crop_off=crop_off, angle=angle, hints=hints, slices=slices,
            syntaxes=syntaxes, bad=bad,
        )

    @staticmethod
    def decode(
        data: bytes,
        backend: str = "auto",
        apply_rotation: bool = True,
        item_id: Optional[int] = None,
        mesh_devices: Optional[int] = None,
        isolate_tile_errors: bool = False,
        stats=None,
    ) -> dict:
        """Decode the primary (or given) image item to YCbCr planes.

        Returns {"Y": ..., "Cb": ..., "Cr": ...} arrays plus "info"
        (uint8, or uint16 for >8-bit streams; Cb/Cr are None for
        monochrome items). backend: "auto" (jax when a device is
        usable, else ref — the documented default), "ref" (numpy host
        reference) or "jax" (device pipeline).
        mesh_devices: shard the tile grid over an N-device jax Mesh
          (grid-tile data parallelism, SURVEY.md §2.2) instead of the
          single-chip batched pipeline.
        isolate_tile_errors: a corrupt tile yields a mid-gray tile and a
          structured error record instead of aborting the whole image
          (SURVEY.md §5 failure-detection row); error details land in
          stats.tile_errors / stats.errors when a DecodeStats is passed.
        """
        if backend == "auto":
            backend = "jax" if _jax_usable() else "ref"

        fe = HeicDecoder.front_end(data, item_id, isolate_tile_errors)
        sps, pps = fe.sps, fe.pps
        slices_good, syntaxes_good, bad = fe.slices, fe.syntaxes, fe.bad
        if stats is not None:
            stats.scheduler = dict(fe.hints)

        # tiles-enabled pictures (intra-picture tile partitioning, rare
        # in HEIF) decode on the fast path (native tile-scan entropy +
        # tile-aware device intra/deblock) EXCEPT two combinations that
        # only the host reference path implements: SAO with
        # loop_filter_across_tiles_enabled_flag=0 (tile-clamped SAO), and
        # the mesh-sharded pipeline (host packer is not tile-aware). Any
        # downgrade is recorded in DecodeStats and logged so perf triage
        # never needs a debugger.
        reason = None
        if pps.tiles_enabled_flag and backend == "jax":
            sh0 = slices_good[0].header
            sao_on = sh0.slice_sao_luma_flag or sh0.slice_sao_chroma_flag
            if (
                not pps.loop_filter_across_tiles_enabled_flag and sao_on
            ):
                reason = (
                    "tiles with loop_filter_across_tiles=0 + SAO: jax "
                    "backend downgraded to ref (tile-clamped SAO is "
                    "host-only)"
                )
            elif mesh_devices:
                reason = (
                    "tiles on a sharded mesh: downgraded to ref (the "
                    "uniform host packer is not tile-aware)"
                )
        if reason is not None:
            backend = "ref"
            if stats is not None:
                stats.scheduler["backend_downgrade"] = reason
            import logging

            logging.getLogger("heif_tpu").info(reason)
        if stats is not None:
            stats.scheduler["effective_backend"] = backend

        # reconstruct (per backend)
        if backend == "ref":
            from heif_tpu.ops.ref_recon import reconstruct_tile

            tiles_good = [
                reconstruct_tile(st, sps, pps, ps.header)
                for st, ps in zip(syntaxes_good, slices_good)
            ]
        elif backend == "jax" and mesh_devices:
            from heif_tpu.parallel.pipeline import (
                decode_grid_sharded,
                make_mesh,
            )

            planes3 = decode_grid_sharded(
                syntaxes_good, sps, pps, slices_good,
                mesh=make_mesh(mesh_devices),
            )
            tiles_good = [
                [planes3[0][i], planes3[1][i], planes3[2][i]]
                for i in range(len(syntaxes_good))
            ]
        elif backend == "jax":
            from heif_tpu.ops.jax_recon import reconstruct_tiles_batched

            tiles_good = reconstruct_tiles_batched(
                syntaxes_good, sps, pps, slices_good
            )
        else:
            raise ValueError(f"unknown backend {backend!r}")

        # re-insert gray placeholders for failed tiles
        if bad:
            th = sps.pic_height_in_luma_samples
            tw = sps.pic_width_in_luma_samples
            bd = max(sps.bit_depth_y, sps.bit_depth_c)
            gdt = np.uint8 if bd <= 8 else np.uint16
            mid = 1 << (bd - 1)
            gray = [
                np.full((th, tw), mid, gdt),
                np.full((th >> 1, tw >> 1), mid, gdt),
                np.full((th >> 1, tw >> 1), mid, gdt),
            ]
            tiles = []
            it = iter(tiles_good)
            for ti in range(len(fe.tile_ids)):
                tiles.append(gray if ti in bad else next(it))
            if stats is not None:
                stats.tile_errors = len(bad)
                stats.errors = {
                    ti: f"{type(e).__name__}: {e}" for ti, e in bad.items()
                }
        else:
            tiles = tiles_good
        if stats is not None:
            stats.tiles = len(fe.tile_ids)

        planes = HeicDecoder._stitch(
            tiles, fe.grid, sps, apply_rotation, fe.angle,
            crop_off=fe.crop_off,
        )
        planes["info"] = fe.info
        return planes

    @staticmethod
    def decode_hevc(stream: bytes, backend: str = "ref") -> dict:
        """Decode a raw single-picture HEVC Annex-B intra stream.

        Exceeds the reference (which only decodes NALs embedded in HEIF
        containers): accepts bare `.hevc` byte streams such as x265
        output, used by the bitstream fixture matrix. Returns
        {"Y", "Cb", "Cr"} uint8 planes. Entropy runs in the native C++
        decoder when it is available, in the Python twin otherwise.
        """
        from heif_tpu.hevc import params
        from heif_tpu.hevc import slice as sl
        from heif_tpu.hevc.rbsp import remove_emulation_prevention
        from heif_tpu.cabac.syntax import TileSyntaxDecoder
        from heif_tpu.hevc import grammar as hg

        sps = pps = None
        slice_nal = None
        for nal in sl.split_annexb_nals(stream):
            kind = (nal[0] >> 1) & 0x3F
            if kind == 33:
                sps = params.parse_sps(remove_emulation_prevention(nal[2:]))
            elif kind == 34:
                pps = params.parse_pps(remove_emulation_prevention(nal[2:]))
            elif kind <= 31 and slice_nal is None:  # first VCL NAL
                slice_nal = nal
        if sps is None or pps is None or slice_nal is None:
            raise ValueError("stream lacks SPS/PPS/slice NAL")
        ps = sl.parse_slice_header(slice_nal, sps, pps)

        from heif_tpu import native

        if pps.tiles_enabled_flag and backend == "jax":
            # one host-only corner: tile-clamped SAO (across=0 + SAO)
            if not pps.loop_filter_across_tiles_enabled_flag and (
                ps.header.slice_sao_luma_flag
                or ps.header.slice_sao_chroma_flag
            ):
                backend = "ref"
        if native.available():
            # the native twin handles 8/10-bit, 4:0:0/4:2:0, and
            # tiles_enabled_flag=1 (tile-scan CTU order + §6.4.1
            # availability; verified bit-exact vs the Python twin by the
            # tiled fixture tests)
            st = native.decode_tile_native(sps, pps, ps)
        else:
            st = TileSyntaxDecoder(sps, pps, ps).decode()

        if backend == "ref":
            from heif_tpu.ops.ref_recon import reconstruct_tile

            y, cb, cr = reconstruct_tile(st, sps, pps, ps.header)
        elif backend == "jax":
            from heif_tpu.ops.jax_recon import reconstruct_tiles_batched

            y, cb, cr = reconstruct_tiles_batched([st], sps, pps, [ps])[0]
        else:
            raise ValueError(f"unknown backend {backend!r}")
        if sps.chroma_format_idc == 0:
            # monochrome: the dummy chroma planes are meaningless —
            # return None like decode() does (zeros would green-tint
            # to_rgb output)
            cb = cr = None
        return {"Y": y, "Cb": cb, "Cr": cr, "sps": sps, "pps": pps}

    @staticmethod
    def _stitch(tiles, grid, sps, apply_rotation: bool, angle: int,
                crop_off: tuple = (0, 0)) -> dict:
        """Assemble decoded tiles into the output canvas, crop to the grid
        output size, and apply irot (CCW multiples of 90 degrees).

        Canvas dtype follows the decoded tile planes (uint8, or uint16 for
        >8-bit streams — allocating uint8 unconditionally silently
        truncated Main-10 output). Monochrome (4:0:0) streams stitch the
        luma canvas only; Cb/Cr are None.
        """
        tw = sps.pic_width_in_luma_samples
        th = sps.pic_height_in_luma_samples
        mono = sps.chroma_format_idc == 0
        dt = tiles[0][0].dtype
        canvas_w, canvas_h = grid.columns * tw, grid.rows * th
        y = np.zeros((canvas_h, canvas_w), dtype=dt)
        if mono:
            cb = cr = None
        else:
            cb = np.zeros((canvas_h >> 1, canvas_w >> 1), dtype=dt)
            cr = np.zeros((canvas_h >> 1, canvas_w >> 1), dtype=dt)
        for i, t in enumerate(tiles):
            r, c = divmod(i, grid.columns)
            y[r * th : (r + 1) * th, c * tw : (c + 1) * tw] = t[0]
            if not mono:
                cb[r * (th >> 1) : (r + 1) * (th >> 1), c * (tw >> 1) : (c + 1) * (tw >> 1)] = t[1]
                cr[r * (th >> 1) : (r + 1) * (th >> 1), c * (tw >> 1) : (c + 1) * (tw >> 1)] = t[2]
        ox, oy = crop_off
        y = y[oy : oy + grid.output_height, ox : ox + grid.output_width]
        if not mono:
            cb = cb[oy >> 1 : (oy >> 1) + (grid.output_height >> 1),
                    ox >> 1 : (ox >> 1) + (grid.output_width >> 1)]
            cr = cr[oy >> 1 : (oy >> 1) + (grid.output_height >> 1),
                    ox >> 1 : (ox >> 1) + (grid.output_width >> 1)]
        if apply_rotation and angle:
            y = np.rot90(y, k=angle).copy()
            if not mono:
                cb = np.rot90(cb, k=angle).copy()
                cr = np.rot90(cr, k=angle).copy()
        return {"Y": y, "Cb": cb, "Cr": cr}

    @staticmethod
    def to_rgb(planes: dict) -> "np.ndarray":
        """YCbCr (BT.601 full-range) -> uint8 RGB HxWx3 for preview/export.

        >8-bit planes are scaled to 8-bit for export; monochrome images
        (Cb/Cr None) replicate luma across the three channels.
        """
        y = planes["Y"]
        bd_shift = 0
        if y.dtype == np.uint16:
            # infer the source bit depth from the info when present
            info = planes.get("info")
            bd = getattr(info, "luma_bit_depth", 10) if info else 10
            bd_shift = bd - 8
        y = (y.astype(np.float32) / (1 << bd_shift)) if bd_shift else y.astype(
            np.float32
        )
        if planes.get("Cb") is None:
            g8 = np.clip(y, 0, 255).astype(np.uint8)
            return np.stack([g8, g8, g8], axis=-1)
        cb = planes["Cb"].astype(np.float32) / (1 << bd_shift) - 128.0
        cr = planes["Cr"].astype(np.float32) / (1 << bd_shift) - 128.0
        cb = np.repeat(np.repeat(cb, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
        cr = np.repeat(np.repeat(cr, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
        r = y + 1.402 * cr
        gch = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        return np.clip(np.stack([r, gch, b], axis=-1), 0, 255).astype(np.uint8)
