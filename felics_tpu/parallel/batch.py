"""Batched multi-image FLCT encode/decode.

Device throughput comes from putting as many tiles as possible into one
program. These helpers take a LIST of images, fuse every tile of every image
into one device program (tiles are uniform (C, tile_h*tile_w) blocks
regardless of source image size), and split the results back into per-image
FLCT containers. This is the production serving path; per-image APIs in
tiling.py are the convenience path.

All images in a batch must share dtype and channel count (tile geometry is
shared); sizes may differ freely.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Sequence

import jax
import numpy as np

from felics_tpu import errors

from felics_tpu.config import TileConfig, tiled_config_for_depth
from felics_tpu.format import PixelDepth
from felics_tpu.ops.kscan_tiled import num_buckets
from felics_tpu.parallel import tiling

# Which path the last batch encode/decode took (the decode engine is in
# tiling.LAST_ENGINE). Both directions:
#   "images"    same-shape batch: tiled (encode) or assembled (decode) on
#               device, raw pixels cross the bus;
#   "tiles"     mixed shapes: tiles prepared (encode) or assembled (decode)
#               on the host;
#   "per-image" an image smaller than the tile: one container at a time.
LAST_PATH = {"encode": None, "decode": None}


def _prep_encode_batch(images: Sequence[np.ndarray], tile: TileConfig):
    """Host-side batch prep of the "tiles" path. Returns None when the
    batch cannot be tiled uniformly (caller encodes per image), else a dict
    of everything the device phase needs."""
    from felics_tpu.api import header_for_array

    headers = [header_for_array(im) for im in images]
    depth = headers[0].pixel_depth
    color = headers[0].color_type
    if any(h.pixel_depth != depth or h.color_type != color for h in headers):
        raise ValueError("batch images must share dtype and channel count")
    th, tw = tile.tile_h, tile.tile_w
    if any(h.height < th or h.width < tw for h in headers):
        return None  # mixed clamping would break tile uniformity

    cfg = tiled_config_for_depth(depth)
    nb = num_buckets(cfg)
    parts = [tiling._prepare_tiles(im, color, th, tw) for im in images]
    counts = [p[0].shape[0] for p in parts]
    c = parts[0][0].shape[1]
    tiles_np = np.concatenate([p[0] for p in parts])
    tile_group = np.repeat(np.arange(len(images)), counts)
    return {
        "headers": headers, "depth": depth, "color": color, "th": th,
        "tw": tw, "cfg": cfg, "nb": nb, "counts": counts, "c": c,
        "tiles_np": tiles_np, "tile_group": tile_group,
    }


def _pack_batch_containers(prep, lengths, payload, k0s) -> List[bytes]:
    tile_pos = np.concatenate([[0], np.cumsum(lengths)])
    out: List[bytes] = []
    t0 = 0
    for header, n_t, k0 in zip(prep["headers"], prep["counts"], k0s):
        t1 = t0 + n_t
        body = payload[tile_pos[t0] : tile_pos[t1]]
        out.append(
            tiling.pack_tiled_container(
                prep["color"], prep["depth"], header.width, header.height,
                prep["tw"], prep["th"], n_t, lengths[t0:t1], bytes(body), k0,
            )
        )
        t0 = t1
    return out


def _encode_dispatch(images: Sequence[np.ndarray], tile: TileConfig):
    """Choose the encode path from the batch's shapes and start it without
    blocking. Returns (path, prep, pending) for ``_encode_finish``."""
    from felics_tpu.api import header_for_array

    im0 = images[0]
    th, tw = tile.tile_h, tile.tile_w
    if (
        all(im.shape == im0.shape and im.dtype == im0.dtype for im in images)
        and im0.shape[0] >= th and im0.shape[1] >= tw
    ):
        headers = [header_for_array(im) for im in images]
        cfg = tiled_config_for_depth(headers[0].pixel_depth)
        p = tiling.encode_dispatch_images(np.stack(images), th, tw, cfg)
        if p is not None:
            ty, tx = -(-im0.shape[0] // th), -(-im0.shape[1] // tw)
            prep = {
                "headers": headers, "depth": headers[0].pixel_depth,
                "color": headers[0].color_type, "th": th, "tw": tw,
                "counts": [ty * tx] * len(images),
            }
            return "images", prep, p
    prep = _prep_encode_batch(images, tile)
    if prep is None:
        return "per-image", None, None
    p = tiling.encode_dispatch_tiles(
        prep["tiles_np"], prep["counts"], th, tw, prep["cfg"]
    )
    return "tiles", prep, p


def _encode_finish(path, prep, p, images, tile) -> List[bytes]:
    if path == "per-image":
        return [tiling.compress_tiled_bytes(im, tile) for im in images]
    lengths, payload, k0s = tiling.encode_finish(p)
    return _pack_batch_containers(prep, lengths, payload, k0s)


def compress_tiled_batch(
    images: Sequence[np.ndarray], tile: Optional[TileConfig] = None,
) -> List[bytes]:
    """Encode a batch of images into FLCT containers, byte-identical to
    per-image ``tiling.compress_tiled_bytes``."""
    if not images:
        return []
    tile = tile or TileConfig()
    path, prep, p = _encode_dispatch(images, tile)
    LAST_PATH["encode"] = path
    return _encode_finish(path, prep, p, images, tile)


def _prep_decode_batch(datas: Sequence[bytes]):
    """Host-side batch prep shared by the one-shot and pipelined decoders.
    Returns None when the containers are not uniform (caller decodes per
    image)."""
    headers = [tiling.read_tiled_header(d) for d in datas]
    h0 = headers[0]
    if any(
        (h.tile_h, h.tile_w, h.pixel_depth, h.color_type)
        != (h0.tile_h, h0.tile_w, h0.pixel_depth, h0.color_type)
        for h in headers
    ) or any(h.n_tiles == 0 for h in headers):
        return None

    cfg = tiled_config_for_depth(h0.pixel_depth)
    th, tw, c = h0.tile_h, h0.tile_w, h0.num_channels
    # A short payload must fail here exactly like the per-image path
    # (tiling.decompress_tiled_bytes) — the concatenation below would
    # otherwise zero-pad the truncated stream and decode wrong pixels.
    for d, h in zip(datas, headers):
        if len(d) - h.payload_off < int(h.tile_lengths.sum()):
            raise errors.IoError("truncated FLCT payload")
    # Exact per-tile stream concatenation (container payloads may carry
    # trailing bytes; slice each to its tile-table total).
    payload = b"".join(
        d[h.payload_off : h.payload_off + int(h.tile_lengths.sum())]
        for d, h in zip(datas, headers)
    )
    lens = np.concatenate([h.tile_lengths for h in headers])
    priors = np.stack([tiling.prior_from_k0(h.k0, cfg, c) for h in headers])
    tile_group = np.repeat(
        np.arange(len(headers)), [h.n_tiles for h in headers]
    )
    same_shape = (
        (h0.height, h0.width)
        if all((h.height, h.width) == (h0.height, h0.width) for h in headers)
        else None
    )
    return {
        "headers": headers, "cfg": cfg, "th": th, "tw": tw, "c": c,
        "payload": payload, "lens": lens, "priors": priors,
        "tile_group": tile_group, "same_shape": same_shape,
        "depth_bits": 8 if h0.pixel_depth == PixelDepth.EIGHT else 16,
    }


def _assemble_batch_images(prep, bufs_np, bad_np, isolate: bool = False):
    th, tw, c = prep["th"], prep["tw"], prep["c"]
    depth_max = (1 << prep["depth_bits"]) - 1
    out: List = []
    t0 = 0
    for h in prep["headers"]:
        ty = -(-h.height // th)
        tx = -(-h.width // tw)
        if bad_np[t0 : t0 + h.n_tiles].any():
            exc = errors.InvalidValue(
                "decoded value does not fit the pixel depth"
            )
            if not isolate:
                raise exc
            out.append(exc)  # per-tile flags isolate the bad image
            t0 += h.n_tiles
            continue
        sub = bufs_np[t0 : t0 + h.n_tiles]
        out.append(
            tiling.assemble_image_np(
                sub, th, tw, c, ty, tx, h.height, h.width, depth_max
            )
        )
        t0 += h.n_tiles
    return out


def _decode_dispatch(prep, engine: str):
    """Start the decode of a prepped batch: same-shape batches assemble on
    device ("images"), mixed shapes on the host ("tiles")."""
    same = prep["same_shape"]
    return tiling.decode_dispatch(
        prep["payload"], prep["lens"], prep["th"], prep["tw"], prep["c"],
        prep["cfg"], prep["priors"], prep["tile_group"], engine,
        same_shape=None if same is None else (len(prep["headers"]), *same),
    )


def _decode_finish(prep, p, isolate: bool) -> List:
    a, b = jax.device_get(p)
    if prep["same_shape"] is None:
        # Narrowed planes: widen before the host's inverse colour transform.
        return _assemble_batch_images(prep, a.astype(np.int32), b, isolate)
    if isolate:  # per-image validity flags -> per-image failures
        return [
            a[i] if b[i]
            else errors.InvalidValue("decoded value does not fit the pixel depth")
            for i in range(a.shape[0])
        ]
    if not b.all():
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
    return [a[i] for i in range(a.shape[0])]


def _decompress_one_isolated(d: bytes, engine: str):
    try:
        return tiling.decompress_tiled_bytes(d, engine)
    except errors.DecompressionError as e:
        return e


def _decode_batch_impl(datas: Sequence[bytes], engine: str, isolate: bool):
    prep = _prep_decode_batch(datas)
    if prep is None:
        LAST_PATH["decode"] = "per-image"
        if isolate:
            return [_decompress_one_isolated(d, engine) for d in datas]
        return [tiling.decompress_tiled_bytes(d, engine) for d in datas]
    LAST_PATH["decode"] = "tiles" if prep["same_shape"] is None else "images"
    return _decode_finish(prep, _decode_dispatch(prep, engine), isolate)


def _screen(datas: Sequence[bytes]):
    """Cheap host-side validation for ``on_error="isolate"``: members with
    corrupt headers or truncated payloads get their exception. Returns
    (indices of the survivors, {index: exception})."""
    good_idx: List[int] = []
    errmap: dict = {}
    for i, d in enumerate(datas):
        try:
            h = tiling.read_tiled_header(d)
            if len(d) - h.payload_off < int(h.tile_lengths.sum()):
                raise errors.IoError("truncated FLCT payload")
            good_idx.append(i)
        except errors.DecompressionError as e:
            errmap[i] = e
    return good_idx, errmap


def decompress_tiled_batch(
    datas: Sequence[bytes], engine: str = "auto", on_error: str = "raise"
) -> List:
    """Decode a batch of FLCT containers.

    ``on_error="raise"`` (default): any corrupt member raises, matching the
    per-image API. ``on_error="isolate"``: each member decodes or fails
    independently — the returned list holds an ``np.ndarray`` per good
    member and the ``DecompressionError`` instance per bad one, so one
    corrupt blob cannot discard the rest of a serving batch (the reference
    decodes images independently by construction)."""
    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    if not datas:
        return []
    if on_error == "raise":
        return _decode_batch_impl(datas, engine, False)
    # The survivors of the screen keep the batched path (one device
    # program).
    results: List = [None] * len(datas)
    good_idx, errmap = _screen(datas)
    for i, e in errmap.items():
        results[i] = e
    if good_idx:
        good = [datas[i] for i in good_idx]
        try:
            decoded = _decode_batch_impl(good, engine, True)
        except errors.DecompressionError:
            # Residual whole-batch failure (no per-image attribution):
            # decode the survivors independently.
            decoded = [_decompress_one_isolated(d, engine) for d in good]
        for i, r in zip(good_idx, decoded):
            results[i] = r
    return results


# ---------------------------------------------------------------------------
# Pipelined streaming. The stream keeps ``depth`` batches in flight: batch
# N+1's host prep, upload and dispatch happen (and its device->host result
# copies start) BEFORE batch N's results are fetched, so host work, transfers
# and device compute overlap wherever the runtime allows. The blocking
# finish halves run at pop time.
# ---------------------------------------------------------------------------


def compress_tiled_stream(
    batches: Iterable[Sequence[np.ndarray]],
    tile: Optional[TileConfig] = None,
    depth: int = 2,
) -> List[List[bytes]]:
    """Encode a stream of image batches with at most ``depth`` batches in
    flight. ``batches`` is consumed LAZILY (a generator works; only the
    in-flight batches are held), results arrive in input order. Returns
    one list of FLCT containers per input batch, byte-identical to
    per-batch ``compress_tiled_batch``."""
    tile = tile or TileConfig()
    results: List[List[bytes]] = []
    pending: deque = deque()

    for images in batches:
        images = list(images)
        # Finish the oldest BEFORE dispatching, so at most ``depth``
        # batches are ever dispatched-and-unfinished.
        while len(pending) >= depth:
            results.append(_encode_finish(*pending.popleft()))
        if not images:
            pending.append(("per-image", None, None, [], tile))
            continue
        path, prep, p = _encode_dispatch(images, tile)
        LAST_PATH["encode"] = path
        pending.append((path, prep, p, images, tile))
    while pending:
        results.append(_encode_finish(*pending.popleft()))
    return results


def decompress_tiled_stream(
    batches: Iterable[Sequence[bytes]],
    engine: str = "auto",
    depth: int = 2,
    on_error: str = "raise",
) -> List[List]:
    """Decode a stream of container batches with at most ``depth`` batches
    in flight (lazy mirror of compress_tiled_stream).

    ``on_error="isolate"``: per-member isolation like
    ``decompress_tiled_batch`` — corrupt members hold their
    ``DecompressionError`` in place while the rest of each batch keeps the
    pipelined path."""
    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    isolate = on_error == "isolate"
    results: List[List] = []
    pending: deque = deque()

    def finish_good(prep, p, datas) -> List:
        if prep is None:
            if isolate:
                return [_decompress_one_isolated(d, engine) for d in datas]
            return [tiling.decompress_tiled_bytes(d, engine) for d in datas]
        return _decode_finish(prep, p, isolate)

    def finish(entry) -> List:
        prep, p, datas, errmap, n_total, good_idx = entry
        if datas:
            try:
                decoded = finish_good(prep, p, datas)
            except errors.DecompressionError:
                if not isolate:
                    raise
                decoded = [_decompress_one_isolated(d, engine) for d in datas]
        else:
            decoded = []
        if not errmap:
            return decoded
        out: List = [None] * n_total
        for i, e in errmap.items():
            out[i] = e
        for i, r in zip(good_idx, decoded):
            out[i] = r
        return out

    for datas in batches:
        datas = list(datas)
        while len(pending) >= depth:
            results.append(finish(pending.popleft()))
        n_total = len(datas)
        errmap: dict = {}
        good_idx = list(range(n_total))
        if isolate and datas:
            good_idx, errmap = _screen(datas)
            datas = [datas[i] for i in good_idx]
        if not datas:
            pending.append((None, None, [], errmap, n_total, good_idx))
            continue
        prep = _prep_decode_batch(datas)
        p = None
        if prep is None:
            LAST_PATH["decode"] = "per-image"
        else:
            LAST_PATH["decode"] = (
                "tiles" if prep["same_shape"] is None else "images"
            )
            p = _decode_dispatch(prep, engine)
        pending.append((prep, p, datas, errmap, n_total, good_idx))
    while pending:
        results.append(finish(pending.popleft()))
    return results
