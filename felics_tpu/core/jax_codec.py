"""Vectorized JAX FLCS codec.

Encoder pipeline (all XLA; see felics_tpu.ops for the building blocks):

    analyze  →  kscan  →  symbolize  →  prefix-sum offsets  →  pack bits

The emitted container is bit-identical to the reference implementation
(oracle-tested): same FLCS header, same bit-continuous multi-channel payload
with one final byte_align (reference: src/compression.rs:365-369).

Host synchronization points (static-shape boundaries): the kscan extents
(active contexts × max per-context updates) and the total bit count before
packing; both are bucketized so repeated encodes hit the jit cache.

Single-stream FLCS *decode* is irreducibly serial per pixel (the context
needs decoded neighbours; the k tables need every prior residual —
SURVEY.md §2 C9), so ``decompress_image_bytes`` here is a ``lax.scan``
reference decoder: correct on-device decode for completeness/testing, while the
production serial decode path is the native C++ core and the *parallel*
decode story is the tiled FLCT format (felics_tpu.parallel).
"""

from __future__ import annotations

import io
from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from felics_tpu import errors
from felics_tpu.coding.bitio import BitWriter
from felics_tpu.config import CodingConfig, config_for_depth
from felics_tpu.core import oracle
from felics_tpu.core.color import rgb_to_ycocg, ycocg_to_rgb
from felics_tpu.format import ColorType, Header, PixelDepth, header_bytes
from felics_tpu.ops import bitpack
from felics_tpu.ops.analysis import Symbols, analyze_channel, symbolize
from felics_tpu.ops.kscan import compute_k

_DTYPES = {PixelDepth.EIGHT: np.uint8, PixelDepth.SIXTEEN: np.uint16}

# HBM budget (bytes) for the vmapped kscan queue scratch in the batched
# FLCS encode; groups whose lanes would exceed it run in lane slices.
_KSCAN_LANE_BUDGET = 1 << 31


@partial(jax.jit, static_argnames=("height", "width"))
def _analyze(channel, height: int, width: int):
    return analyze_channel(channel, height, width)


@partial(jax.jit, static_argnames=("height", "width"))
def _symbolize(analysis, channel, k, height: int, width: int) -> Symbols:
    return symbolize(analysis, channel, k, height, width)


def encode_channel_symbols(
    channel: jnp.ndarray, height: int, width: int, cfg: CodingConfig
) -> Symbols:
    """Full parallel pipeline for one channel → per-pixel symbols."""
    analysis = _analyze(channel, height, width)
    k = compute_k(analysis.context, analysis.oor, analysis.residual, cfg)
    return _symbolize(analysis, channel, k, height, width)


def _concat_symbols(parts: Sequence[Symbols]) -> Symbols:
    return Symbols(
        a_val=jnp.concatenate([p.a_val for p in parts]),
        a_len=jnp.concatenate([p.a_len for p in parts]),
        q=jnp.concatenate([p.q for p in parts]),
        b_val=jnp.concatenate([p.b_val for p in parts]),
        b_len=jnp.concatenate([p.b_len for p in parts]),
    )


def encode_payload(
    channels: Sequence[np.ndarray], height: int, width: int, cfg: CodingConfig
) -> bytes:
    """Encode flat int32 channels into the byte-aligned FLCS payload."""
    n = height * width
    if n < 2 or width == 0 or height == 0:
        # Degenerate dims: raw preamble only — delegate to the scalar path
        # (reference: src/compression.rs:92-103).
        writer = BitWriter()
        for chan in channels:
            oracle.compress_channel(
                np.asarray(chan, dtype=np.int64), width, height, cfg, writer
            )
        writer.byte_align()
        return writer.getvalue()

    parts = [
        encode_channel_symbols(jnp.asarray(chan, dtype=jnp.int32), height, width, cfg)
        for chan in channels
    ]
    symbols = _concat_symbols(parts) if len(parts) > 1 else parts[0]
    offsets, total = bitpack.symbol_offsets(symbols)
    n_big = bitpack.count_big_symbols(symbols)
    total_bits, n_big = (int(x) for x in jax.device_get((total, n_big)))
    b_pad = bitpack.bucket_bits(total_bits)
    from felics_tpu.parallel.tiling import _bucket_count

    n_big_pad = min(_bucket_count(n_big), offsets.shape[0])
    packed = bitpack.pack_bits_scatter(symbols, offsets, b_pad, n_big_pad)
    total_bytes = (total_bits + 7) // 8
    return bytes(np.asarray(packed[:total_bytes]).tobytes())


def compress_image_bytes(image: np.ndarray, header: Header) -> bytes:
    cfg = config_for_depth(header.pixel_depth)
    h, w = header.height, header.width
    return header_bytes(header) + encode_payload(
        _image_channels(image, header), h, w, cfg
    )


def _image_channels(image: np.ndarray, header: Header):
    if header.color_type == ColorType.GRAY:
        return [np.asarray(image, dtype=np.int32).reshape(-1)]
    flat = np.asarray(image, dtype=np.int32).reshape(-1, 3)
    y, co, cg = rgb_to_ycocg(flat[:, 0], flat[:, 1], flat[:, 2])
    return [y, co, cg]


@partial(jax.jit, static_argnames=("n_imgs",))
def _group_offsets(symbols: Symbols, n_imgs: int):
    """Byte-aligned per-image packing offsets for a group of same-shape
    images whose symbols are concatenated image-major (same pattern as the
    FLCT per-tile offsets: each image's stream is an independent byte-aligned
    FLCS payload inside one scatter buffer)."""
    lens = (symbols.a_len + symbols.q + symbols.b_len).reshape(n_imgs, -1)
    ends = jnp.cumsum(lens, axis=1, dtype=jnp.int32)
    img_bits = ends[:, -1]
    img_bytes = (img_bits + 7) >> 3
    img_starts = jnp.cumsum(img_bytes) - img_bytes  # exclusive, bytes
    within = ends - lens
    offsets = (img_starts[:, None] << 3) + within
    return offsets.reshape(-1), img_bytes, img_starts[-1] + img_bytes[-1]


@partial(jax.jit, static_argnames=("height", "width"))
def _analyze_sort_batch(chans, height: int, width: int):
    """vmapped analysis + update sort over a (G, H*W) stack of same-shape
    channels (lanes = every channel of every image in a shape group): ONE
    dispatch regardless of batch size, where the per-channel form cost two
    dispatches PER CHANNEL, whose fixed cost dominated batched FLCS encode
    otherwise."""
    from felics_tpu.ops.kscan import sort_updates

    def one(ch):
        analysis = analyze_channel(ch, height, width)
        return analysis, sort_updates(analysis.context, analysis.oor)

    return jax.vmap(one)(chans)


@partial(jax.jit, static_argnames=("height", "width", "cfg", "c_pad", "r_pad"))
def _kscan_symbolize_batch(
    analysis, chans, sus, height: int, width: int, cfg: CodingConfig,
    c_pad: int, r_pad: int,
):
    """vmapped kscan + symbolize over the same (G, H*W) lanes. The pads
    are the GROUP maxima (bucketized): padding only adds capacity — the
    scan output is exact for every lane regardless, and lanes with zero
    out-of-range pixels never read their (meaningless) k."""
    from felics_tpu.ops.kscan import kscan

    def one(a, ch, su):
        k = kscan(a.context, a.oor, a.residual, su, cfg, c_pad, r_pad)
        return symbolize(a, ch, k, height, width)

    return jax.vmap(one)(analysis, chans, sus)


def compress_images_bytes(images: Sequence[np.ndarray]) -> List[bytes]:
    """Batched multi-image FLCS encode: N containers from ~four device
    round trips PER SHAPE GROUP (vs ~4 per image when encoding
    sequentially, and vs ~4 per CHANNEL in the r4 form — every per-channel
    stage is now one vmapped dispatch over the group's channel lanes).

    Bytes are identical to per-image ``compress_image_bytes`` (reference
    parity: one continuous bitstream per image, src/compression.rs:365-369;
    pinned by tests/test_batched_flcs.py). Images may differ in shape;
    same-shape runs share jit cache entries.
    """
    from felics_tpu.api import header_for_array
    from felics_tpu.ops.kscan import _bucket
    from felics_tpu.parallel.tiling import _bucket_count

    if not images:
        return []
    headers = [header_for_array(im) for im in images]

    # Group by shape/depth/color; degenerate dims use the scalar path.
    groups: dict = {}  # (h, w, c, depth) -> [(image_index, header, image)]
    results: List[bytes] = [b"" for _ in images]
    for idx, (im, hd) in enumerate(zip(images, headers)):
        h, w = hd.height, hd.width
        if h * w < 2 or w == 0 or h == 0:
            results[idx] = compress_image_bytes(im, hd)
            continue
        key = (h, w, hd.num_channels, hd.pixel_depth)
        groups.setdefault(key, []).append((idx, hd, im))

    for (h, w, c, depth), members in groups.items():
        cfg = config_for_depth(depth)
        n_imgs = len(members)
        # (G, n) lane stack: image-major, channel-major — the same order
        # the per-image concatenation used, so flattening the vmapped
        # symbol arrays reproduces the exact packing layout.
        chans_np = np.stack(
            [ch for _i, hd, im in members for ch in _image_channels(im, hd)]
        ).astype(np.int32)
        chans = jnp.asarray(chans_np)
        analysis, sus = _analyze_sort_batch(chans, h, w)
        nc_mr = jax.device_get((sus.num_contexts, sus.max_rank))  # ONE sync
        c_pad = _bucket(max(1, int(np.max(nc_mr[0]))))
        r_pad = _bucket(max(1, int(np.max(nc_mr[1]))))
        # kscan's queue scratch is (c_pad, r_pad) int32 PER LANE; cap the
        # vmapped lanes so a big batch of busy images cannot multiply that
        # into HBM exhaustion (slices recompile per distinct shape — only
        # reached for huge groups).
        G = chans.shape[0]
        max_lanes = max(1, _KSCAN_LANE_BUDGET // max(c_pad * r_pad * 16, 1))
        if G <= max_lanes:
            sym_b = _kscan_symbolize_batch(
                analysis, chans, sus, h, w, cfg, c_pad, r_pad
            )
        else:
            parts = []
            for s in range(0, G, max_lanes):
                sl = slice(s, min(s + max_lanes, G))
                parts.append(
                    _kscan_symbolize_batch(
                        jax.tree.map(lambda x: x[sl], analysis),
                        chans[sl],
                        jax.tree.map(lambda x: x[sl], sus),
                        h, w, cfg, c_pad, r_pad,
                    )
                )
            sym_b = jax.tree.map(lambda *xs: jnp.concatenate(xs), *parts)
        symbols = Symbols(*(f.reshape(-1) for f in sym_b))
        _pack_group(symbols, members, n_imgs, results, _bucket_count)
    return results


def _pack_group(symbols, members, n_imgs, results, _bucket_count):
    """Offsets + one scatter pack program + one payload fetch for a
    same-shape image group; split at per-image byte boundaries."""
    offsets, img_bytes, total_bytes = _group_offsets(symbols, n_imgs)
    n_big = bitpack.count_big_symbols(symbols)
    total, n_big = (int(x) for x in jax.device_get((total_bytes, n_big)))
    b_pad = bitpack.bucket_bits(total * 8)
    n_big_pad = min(_bucket_count(n_big), offsets.shape[0])
    packed = bitpack.pack_bits_scatter(symbols, offsets, b_pad, n_big_pad)
    payload = np.asarray(packed[:total]).tobytes()
    lengths = np.asarray(img_bytes, dtype=np.int64)
    pos = np.concatenate([[0], np.cumsum(lengths)])
    for mi, (idx, hd, _im) in enumerate(members):
        results[idx] = header_bytes(hd) + payload[pos[mi] : pos[mi + 1]]


# ---------------------------------------------------------------------------
# Sequential lax.scan decoder (reference oracle on-device).
# ---------------------------------------------------------------------------


def _bits_to_words(data: bytes, start_bit: int):
    """Payload bytes → uint32 big-endian word array + starting bit offset."""
    payload = np.frombuffer(data, dtype=np.uint8)
    pad = (-len(payload)) % 4
    if pad:
        payload = np.concatenate([payload, np.zeros(pad, np.uint8)])
    words = payload.reshape(-1, 4).astype(np.uint32)
    words = (words[:, 0] << 24) | (words[:, 1] << 16) | (words[:, 2] << 8) | words[:, 3]
    return jnp.asarray(words), start_bit


def _read_bits(words, pos, nbits_max: int):
    """Read ``nbits_max`` (static, <= 32) bits starting at bit ``pos``.

    Returns uint32 holding the stream bits in its low ``nbits_max`` bits
    (first stream bit most significant). Pure 32-bit ops — JAX's default
    32-bit mode has no uint64. Reads beyond the buffer yield zeros.
    """
    word_idx = pos >> 5
    bit_off = (pos & 31).astype(jnp.uint32)
    w0 = words[word_idx]
    w1 = words[jnp.minimum(word_idx + 1, words.shape[0] - 1)]
    # 32-bit window starting at ``pos``, MSB-aligned.
    hi = w0 << bit_off
    lo = jnp.where(bit_off > 0, w1 >> (jnp.uint32(32) - bit_off), jnp.uint32(0))
    window = hi | lo
    if nbits_max == 32:
        return window
    return window >> jnp.uint32(32 - nbits_max)


@partial(jax.jit, static_argnames=("height", "width", "cfg"))
def decode_channel_scan(
    words: jnp.ndarray,
    start_bit,
    height: int,
    width: int,
    cfg: CodingConfig,
):
    """Sequential per-pixel decode as a lax.scan; returns
    (pixels, end_bit, overran) — ``overran`` is True when any unary read
    ran off the end of the word buffer (corrupt all-ones tail).

    One scan step per pixel: peek 64 bits at the cursor, decode the marker +
    phase-in/Rice codeword arithmetically (count-leading-ones for the unary
    part via a fixed-point loop over 32-bit windows), update the k table,
    advance the cursor. State: (bit cursor, k table, decoded ring of the
    previous row — the full buffer is carried since W is static).
    """
    n = height * width
    k_values = jnp.asarray(cfg.k_values, dtype=jnp.int32)
    num_k = cfg.num_k

    from felics_tpu.core.context import neighbour_indices

    a_idx, b_idx = neighbour_indices(height, width, xp=jnp)

    max_context = cfg.max_context
    # Dense table: fine for 8-bit (511 rows); for 16-bit we rely on XLA/HBM.
    table_rows = max_context + 1

    bit_limit = jnp.int32(words.shape[0] * 32)

    def read_unary(pos):
        # Count leading ones from bit position pos, consuming the terminator.
        def cond(state):
            q, p, done, hit = state
            return ~done

        def body(state):
            q, p, done, hit = state
            window = _read_bits(words, p, 32)
            # leading ones = count of leading zeros of the inverted window
            inverted = (~window) & jnp.uint32(0xFFFFFFFF)
            lead = jnp.where(inverted == 0, 32, jax.lax.clz(inverted)).astype(
                jnp.int32
            )
            # p >= bit_limit: a corrupt stream whose tail is all-ones ran off
            # the end (the _read_bits gather clamps to the last word, so the
            # loop would otherwise never see a zero). Stop AND record the
            # overrun explicitly: the end-position check alone cannot catch a
            # word-aligned payload whose runaway lands exactly on
            # payload_bits. (Reference returns DecompressionError on this
            # path: src/compression.rs:205-244.)
            finished = (lead < 32) | (p >= bit_limit)
            hit = hit | ((lead == 32) & finished)
            q = q + lead
            p = p + lead + jnp.where(finished & (lead < 32), 1, 0)
            return q, p, finished, hit

        q0 = jnp.int32(0)
        q, p, _, hit = jax.lax.while_loop(
            cond, body, (q0, pos, jnp.bool_(False), jnp.bool_(False))
        )
        return q, p, hit

    def step(state, i):
        pos, table, buf, ov = state
        va = buf[a_idx[i]]
        vb = buf[b_idx[i]]
        h = jnp.maximum(va, vb)
        l = jnp.minimum(va, vb)
        ctx = jnp.clip(h - l, 0, max_context)

        row = table[ctx]
        best = (num_k - 1) - jnp.argmin(row[::-1])
        k = k_values[best]

        first = _read_bits(words, pos, 1)
        pos1 = pos + 1

        # --- in-range branch: phase-in decode over n = ctx+1 ---
        nn = ctx + 1
        m = 31 - jax.lax.clz(nn)
        left_p = nn - (1 << m)
        right_p = (1 << (m + 1)) - nn
        first_m = _read_bits(words, pos1, 32) >> (32 - m).astype(jnp.uint32)
        first_m = jnp.where(m > 0, first_m, 0).astype(jnp.int32)
        short = first_m < right_p
        extra_bit = _read_bits(words, pos1 + m, 1).astype(jnp.int32)
        long_number = (first_m - right_p) * 2 + right_p + extra_bit
        number = jnp.where(short, first_m, long_number)
        phase_val = (number + left_p) % nn
        phase_len = jnp.where(short, m, m + 1)
        in_value = phase_val + l
        in_pos = pos1 + phase_len

        # --- out-of-range branch: second marker bit + Rice ---
        above = _read_bits(words, pos1, 1)
        q, pos_after_unary, unary_hit = read_unary(pos1 + 1)
        rem = _read_bits(words, pos_after_unary, 32) >> (32 - k).astype(jnp.uint32)
        rem = jnp.where(k > 0, rem, 0).astype(jnp.int32)
        encoded = (q << k) + rem
        oor_value = jnp.where(above == 1, encoded + h + 1, l - encoded - 1)
        oor_pos = pos_after_unary + k

        # k-table update only on the out-of-range path; in-range leaves the
        # row unchanged (add 0, no halving), so one unconditional scatter
        # avoids materializing a second copy of the whole table per step.
        is_in = first == 1
        add_row = jnp.where(is_in, 0, (encoded >> k_values) + 1 + k_values)
        new_row = row + add_row
        if cfg.count_scaling is not None:
            halve = (jnp.min(new_row) > cfg.count_scaling) & ~is_in
            new_row = jnp.where(halve, new_row >> 1, new_row)

        value = jnp.where(is_in, in_value, oor_value)
        new_pos = jnp.where(is_in, in_pos, oor_pos)
        table = table.at[ctx].set(new_row)
        buf = buf.at[i].set(value)
        # The unary read is speculative on the in-range branch (both
        # branches execute; jnp.where selects) — only count its overrun
        # when the out-of-range branch was actually taken.
        ov = ov | (unary_hit & ~is_in)
        return (new_pos, table, buf, ov), None

    p0 = jnp.int32(start_bit)
    pixel1 = jax.lax.bitcast_convert_type(_read_bits(words, p0, 32), jnp.int32)
    pixel2 = jax.lax.bitcast_convert_type(
        _read_bits(words, p0 + 32, 32), jnp.int32
    )
    buf = jnp.zeros((n,), jnp.int32).at[0].set(pixel1).at[1].set(pixel2)
    table = jnp.zeros((table_rows, num_k), jnp.int32)

    (end_pos, _, buf, overran), _ = jax.lax.scan(
        step,
        (p0 + 64, table, buf, jnp.bool_(False)),
        jnp.arange(2, n, dtype=jnp.int32),
    )
    return buf, end_pos, overran


def _channels_to_image(channels: List[np.ndarray], header: Header) -> np.ndarray:
    """Decoded int channel planes -> validated (H, W[, 3]) image."""
    dtype = _DTYPES[header.pixel_depth]
    h, w = header.height, header.width
    if header.color_type == ColorType.GRAY:
        chan = channels[0]
        _validate_range(chan, dtype)
        return chan.astype(dtype).reshape(h, w)
    r, g, b = ycocg_to_rgb(
        channels[0].astype(np.int32),
        channels[1].astype(np.int32),
        channels[2].astype(np.int32),
    )
    for c in (r, g, b):
        _validate_range(c, dtype)
    return np.stack([r, g, b], axis=-1).astype(dtype).reshape(h, w, 3)


def decompress_image_bytes(data: bytes, header: Header) -> np.ndarray:
    cfg = config_for_depth(header.pixel_depth)
    h, w = header.height, header.width
    n = h * w

    if n < 2:
        # Degenerate dims: use the scalar oracle (raw preamble only).
        from felics_tpu import api

        return api.decompress_image_bytes(data, backend="oracle")

    words, _ = _bits_to_words(data[14:], 0)
    payload_bits = (len(data) - 14) * 8
    channels: List[np.ndarray] = []
    pos = 0
    overran = False
    for _ in range(header.num_channels):
        buf, pos, ov = decode_channel_scan(words, pos, h, w, cfg)
        overran = overran or bool(ov)
        channels.append(np.asarray(buf, dtype=np.int64))
    # A corrupt/truncated stream drives the cursor past the payload (the
    # word gather clamps, so decoding "continues" on garbage); reject it
    # like the reference's error-returning reads (src/compression.rs:205-244).
    # ``overran`` additionally catches the word-aligned case where a unary
    # runaway lands exactly on payload_bits (end check alone passes).
    if overran or int(pos) > payload_bits:
        raise errors.IoError("FLCS payload ended prematurely")
    return _channels_to_image(channels, header)


@partial(jax.jit, static_argnames=("height", "width", "cfg", "channels"))
def _decode_images_scan(
    words_batch, height: int, width: int, cfg: CodingConfig, channels: int
):
    """vmapped multi-channel FLCS scan decode: lanes = images (same
    dims/depth/color; word buffers zero-padded to a shared bucket).
    Returns ((n_imgs, C, H*W) planes, (n_imgs,) end bit positions,
    (n_imgs,) unary-overrun flags)."""

    def one(words):
        pos = jnp.int32(0)
        ov = jnp.bool_(False)
        chans = []
        for _ in range(channels):
            buf, pos, ov_c = decode_channel_scan(words, pos, height, width, cfg)
            ov = ov | ov_c
            chans.append(buf)
        return jnp.stack(chans), pos, ov

    return jax.vmap(one)(words_batch)


def decompress_images_bytes(
    datas: Sequence[bytes], on_error: str = "raise"
) -> List:
    """Batched multi-image FLCS decode (mirror of compress_images_bytes):
    same-shape containers decode as ONE vmapped scan program — lanes =
    images, so a batch costs one dispatch + one fetch instead of N. Bytes
    past each image's true payload are zero-padding (never read by a
    valid stream); per-image end-position and range validation matches
    the per-image decoder exactly.

    ``on_error="raise"`` (default): any corrupt member raises, matching
    ``decompress_image_bytes``. ``on_error="isolate"``: members decode or
    fail independently — the returned list holds the image per good member
    and the ``DecompressionError`` instance per bad one (per-image
    validation already runs per lane, so good members cost nothing
    extra)."""
    from felics_tpu.format import read_header_bytes
    from felics_tpu.parallel.tiling import _bucket_count

    if on_error not in ("raise", "isolate"):
        raise ValueError("on_error must be 'raise' or 'isolate'")
    isolate = on_error == "isolate"
    datas = list(datas)
    results: List = [None] * len(datas)
    groups: dict = {}
    for idx, data in enumerate(datas):
        try:
            header = read_header_bytes(data)
            if header.height * header.width < 2:
                results[idx] = decompress_image_bytes(data, header)
                continue
        except errors.DecompressionError as e:
            if not isolate:
                raise
            results[idx] = e
            continue
        payload = np.frombuffer(data[14:], dtype=np.uint8)
        wl = _bucket_count(-(-len(payload) // 4), 64)
        key = (
            header.height, header.width, header.color_type,
            header.pixel_depth, wl,
        )
        groups.setdefault(key, []).append((idx, header, payload))

    for (h, w, color, depth, wl), members in groups.items():
        cfg = config_for_depth(depth)
        c = 1 if color == ColorType.GRAY else 3
        wb = np.zeros((len(members), wl), np.uint32)
        for mi, (_idx, _hd, payload) in enumerate(members):
            pad = (-len(payload)) % 4
            pw = np.concatenate([payload, np.zeros(pad, np.uint8)])
            pw = pw.reshape(-1, 4).astype(np.uint32)
            words = (pw[:, 0] << 24) | (pw[:, 1] << 16) | (pw[:, 2] << 8) | pw[:, 3]
            wb[mi, : len(words)] = words
        bufs, ends, ovs = _decode_images_scan(jnp.asarray(wb), h, w, cfg, c)
        bufs_np, ends_np, ovs_np = jax.device_get((bufs, ends, ovs))
        for mi, (idx, hd, payload) in enumerate(members):
            try:
                if bool(ovs_np[mi]) or int(ends_np[mi]) > len(payload) * 8:
                    raise errors.IoError("FLCS payload ended prematurely")
                chans = [
                    np.asarray(bufs_np[mi, ci], dtype=np.int64)
                    for ci in range(c)
                ]
                results[idx] = _channels_to_image(chans, hd)
            except errors.DecompressionError as e:
                if not isolate:
                    raise
                results[idx] = e
    return results


def _validate_range(chan: np.ndarray, dtype) -> None:
    info = np.iinfo(dtype)
    if chan.size and (chan.min() < info.min or chan.max() > info.max):
        raise errors.InvalidValue("decoded value does not fit the pixel depth")
