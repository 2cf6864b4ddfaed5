"""Numpy models of the port's kernels' decompositions.

Each model follows its CUDA kernel (lane_tracker_tpu_torch/csrc/
filter_stage.cu) step for step: the same tiles, halos, fills, shared
buffers and their order of writes, with every value the kernel computes
at the byte it lands on.  The kernels keep four pixels a 32-bit word and
four words a 16-byte quad, little-endian, so a shift of a word by s pixels
(``__funnelshift_r`` of two neighbours) is a shift of the buffer's bytes
by s; the models work on those bytes.  The tophat's min/max runs on
16-bit lanes with the pixels in their high bytes, which gives each byte's
min/max whatever the low bytes hold; the model takes it per byte.  The
staged tophat (lt_tophat_staged) keeps each pixel's bf16 or f32 bit
pattern in 2- or 4-byte lanes, 8 or 4 pixels a quad, and takes min/max on
the patterns as unsigned integers (DPX); its model works on those lanes
(uint16 or uint32 views of buffers of random bytes).  A test
that holds a model equal to the plain twin for every k the wrapper takes
checks the decomposition and the index arithmetic the kernel shares with
it; what the model cannot see (the word and quad bookkeeping inside one
instruction) the card-only tests check against the twin.

The merge + open + prefix tail's model packs 32 binary pixels a word as the
kernel does (uint64 arrays hold the 32-bit words; funnel shifts, fills,
bands and popcount prefixes as in open_tail_kernel).  Probe 6's model lists
the wgmma tiles sweep_dots_kernel issues and sums their products in
float64.
"""

from __future__ import annotations

import numpy as np
import torch

from lane_tracker_tpu_torch.ops.morphology import ellipse_runs

# ---- tophat (lt_tophat: tophat_kernel; lt_tophat_staged; lt_dual_tophat) ----

GUARD = 48  # bytes of guard before and after each u8 buffer (3 quads)
# Bytes a pixel of the tophat's planes: u8 (lt_tophat), bf16 and f32 bit
# patterns (lt_tophat_staged), and each lane's numpy type.
ELEMS = (1, 2, 4)
LANES = {1: np.uint8, 2: np.uint16, 4: np.uint32}
TOP_THREADS = 512
# The kernel's CTA shapes (kTopShapes in csrc/tophat.cuh): (quads a
# thread holds, the planner's weight of its accesses x 10, shared memory a
# CTA): two CTAs an SM, or one.
TOP_SHAPES = ((6, 13, 110 * 1024), (10, 10, 227 * 1024))


def plane_guard(elem: int) -> int:
    """Guard quads before and after each buffer (plane_guard in
    csrc/tophat.cuh): at least the quads a shift of 31 pixels reaches."""
    return 3 if elem == 1 else 2 * elem


def encode(x: np.ndarray, elem: int) -> np.ndarray:
    """Pixels 0..255 as the lanes' patterns: u8, or the bf16 or f32 bit
    pattern (bf16: the top half of the f32 one, exact for 8 bits)."""
    if elem == 1:
        return x.astype(np.uint8)
    bits = x.astype(np.float32).view(np.uint32)
    return (bits >> 16).astype(np.uint16) if elem == 2 else bits


def decode(x: np.ndarray, elem: int) -> np.ndarray:
    """The lanes' patterns back to u8 pixels."""
    if elem == 1:
        return x.astype(np.uint8)
    bits = x.astype(np.uint32) << np.uint32(16) if elem == 2 else x
    return bits.astype(np.uint32).view(np.float32).astype(np.uint8)


def random_lanes(rng, n: int, elem: int) -> np.ndarray:
    """n lanes of random bytes."""
    return rng.integers(0, 256, n * elem).astype(np.uint8).view(LANES[elem])


def half_widths(k: int) -> list:
    """w[d]: the half-width of the ellipse's rows at |dy| = d, d = 0..r;
    the kernel takes odd k only (symmetric runs)."""
    r = k // 2
    runs = dict(ellipse_runs(k))
    assert all(runs[d] == (-runs[d][1], runs[d][1]) == runs[-d]
               for d in range(r + 1))
    return [runs[d][1] for d in range(r + 1)]


def tophat_steps(k: int) -> list:
    """The kernel's plan: (shift, dlo, dhi, dneed) per step.  Step 0 (shift
    0) gathers the rows at distances [dlo, dhi] whose half-width is 0 from
    the staged plane itself; each later step widens the plane's horizontal
    window from half-width h to h + shift (min of the plane shifted by
    -shift, 0 and +shift, exact while shift <= 2h + 1) and gathers the
    rows of its new half-width (none where it is a stride on the way).
    dneed: the largest distance any step from this one on gathers, so the
    rows the widening must cover."""
    w = half_widths(k)
    span = {}
    for d, u in enumerate(w):
        lo, hi = span.get(u, (d, d))
        span[u] = (min(lo, d), max(hi, d))
    steps = [(0, *span.get(0, (1, 0)))]
    cur = 0
    for u in sorted(set(w) - {0}):
        while cur < u:
            s = min(u - cur, 2 * cur + 1)
            cur += s
            steps.append((s, *(span[u] if cur == u else (1, 0))))
    out, need = [], -1
    for s, lo, hi in reversed(steps):
        if lo <= hi:
            need = max(need, hi)
        out.append((s, lo, hi, need))
    return out[::-1]


def _round16(x):
    return -(-x // 16) * 16


def tophat_plan(k: int, H: int, W: int, elem: int = 1) -> dict:
    """The kernel's host planner (tophat_plan in csrc/tophat.cuh) for
    an H x W frame in planes of elem bytes a pixel: tiles of 4 to 16 elem
    quads, each the tallest (a multiple of 8, at most 256) that fits the
    shape; the fewest estimated shared-memory accesses, weighted by the
    shape (u8: the two-CTA shape only).  {tw, th, tq, rq, shape, smem}."""
    r = k // 2
    P = 16 // elem
    rq = -(-r // P)
    n = len(tophat_steps(k))
    guard = plane_guard(elem)
    hmax = min(-(-H // 8) * 8, 256)
    best = None
    for sh, (quads, gain, limit) in enumerate(TOP_SHAPES[:1 if elem == 1
                                                         else 2]):
        cap = quads * TOP_THREADS
        for tq in range(4, 16 * elem + 1, 4):
            nqx, nqe = tq + 4 * rq, tq + 2 * rq
            th = 0
            for h in range(8, hmax + 1, 8):
                smem = 2 * 16 * ((h + 4 * r) * nqx + 2 * guard)
                if smem <= limit and (h + 2 * r) * nqe <= cap and h * tq <= cap:
                    th = h
            if th == 0:
                continue
            rows_x, rows_e = th + 4 * r, th + 2 * r
            tile = (6 * n * (rows_x * nqx + rows_e * nqe)
                    + 2 * (2 * r + 1) * (rows_e * nqe + th * tq)
                    + rows_x * nqx)
            cost = tile * -(-H // th) * -(-W // (P * tq))
            if best is None or cost * best[1] < best[0] * gain:
                best = (cost, gain, dict(
                    tw=P * tq, th=th, tq=tq, rq=rq, shape=sh,
                    smem=2 * 16 * ((th + 4 * r) * nqx + 2 * guard)))
    return best[2]


def tophat_tiles(k: int, H: int, W: int, elem: int = 1) -> tuple:
    """(tile width, tile height) the kernel's host planner picks for an
    H x W frame (tophat_plan)."""
    p = tophat_plan(k, H, W, elem)
    return p["tw"], p["th"]


def tophat_model(img: np.ndarray, k: int, tw: int, th: int,
                 rng: np.random.Generator, elem: int = 1) -> np.ndarray:
    """img - open(img) with the k x k ellipse, as tophat_tile computes it
    with (tw, th) output tiles in planes of elem bytes a pixel (tw a
    multiple of the 16 / elem pixels a quad); buffers start as random
    bytes."""
    T, H, W = img.shape
    r = k // 2
    P = 16 // elem
    rp = -(-r // P) * P  # the radius rounded up to quads, in pixels
    g = plane_guard(elem) * P  # guard lanes
    steps = tophat_steps(k)
    out = np.zeros_like(img)
    nrx, bx = th + 4 * r, tw + 4 * rp  # staged rows, row lanes
    nre, be = th + 2 * r, tw + 2 * rp  # eroded rows, row lanes
    size = nrx * bx
    for z in range(T):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                bufs = [random_lanes(rng, size + 2 * g, elem)
                        for _ in range(2)]
                # Stage: 255 outside the image.
                gy = np.arange(y0 - 2 * r, y0 - 2 * r + nrx)[:, None]
                gx = np.arange(x0 - 2 * rp, x0 - 2 * rp + bx)[None, :]
                inside = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
                x = np.full((nrx, bx), 255, np.uint8)
                x[inside] = img[z][np.clip(gy, 0, H - 1),
                                   np.clip(gx, 0, W - 1)][inside]
                bufs[0][g:g + size] = encode(x, elem).reshape(-1)
                # Erode: acc over the eroded region (rows r.., lanes rp..).
                acc = _morph(bufs, steps, np.minimum, nrx, bx, r, rp, nre,
                             be, encode(np.uint8(255), elem), g)
                # E into buffer 0: 0 outside the image (the dilate's pad).
                gy = np.arange(y0 - r, y0 - r + nre)[:, None]
                gx = np.arange(x0 - rp, x0 - rp + be)[None, :]
                inside = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
                bufs[0][g:g + nre * be] = np.where(inside, acc, 0).reshape(-1)
                dil = _morph(bufs, steps, np.maximum, nre, be, r, rp, th,
                             tw, 0, g)
                ys, xs = min(th, H - y0), min(tw, W - x0)
                src = img[z, y0:y0 + ys, x0:x0 + xs]
                out[z, y0:y0 + ys, x0:x0 + xs] = src - decode(dil[:ys, :xs],
                                                              elem)
    return out


def _morph(bufs, steps, op, nrows, pitch, r, r16, orows, obytes, init,
           g=GUARD):
    """One phase: the source plane (nrows x pitch lanes) in bufs[0] from
    lane g on; returns the (orows, obytes) result at rows r.., lanes
    r16.. (lanes are bytes for u8)."""
    acc = np.full((orows, obytes), init, bufs[0].dtype)
    rows = np.arange(orows)[:, None] + r
    cols = np.arange(obytes)[None, :] + r16
    src = 0
    for j, (s, lo, hi, need) in enumerate(steps):
        if j > 0:
            dst = 1 - src
            # Widen the rows [r - need, orows + r + need) only; the rest
            # of dst keeps what it held.
            a = (r - need) * pitch
            b = (orows + r + need) * pitch
            i = np.arange(a, b) + g
            sb = bufs[src]
            bufs[dst][i] = op(sb[i], op(sb[i - s], sb[i + s]))
            src = dst
        for d in range(lo, hi + 1):
            for dd in (-d, d):
                acc = op(acc, bufs[src][g + (rows + dd) * pitch + cols])
    return acc


def dual_tiles(ka: int, kb: int, T: int, H: int, W: int) -> list:
    """dual_tophat_kernel's grid: for each block index, the (problem,
    frame, tile row, tile column) it decodes (tile_of), each problem at
    its lt_tophat plan; the larger k's problem (0 for a, 1 for b) first."""
    order = (1, 0) if kb > ka else (0, 1)
    out = []
    for prob in order:
        p = tophat_plan((ka, kb)[prob], H, W)
        gx, gy = -(-W // p["tw"]), -(-H // p["th"])
        for t in range(T * gx * gy):
            z, rem = divmod(t, gx * gy)
            out.append((prob, z, *divmod(rem, gx)))
    return out


# ---- cross threshold (lt_cross_threshold: threshold_kernel) ----

THR_TW, THR_TH, THR_THREADS = 128, 128, 256


def threshold_model(img, k, C, noise_thresh=-1):
    """The bilateral cross threshold as threshold_kernel computes it:
    (THR_TH, THR_TW) tiles; a zero-padded strip; row walkers (two per
    row, 64 columns each) keep the left and right arm sums and leave the
    horizontal hits as bits; column walkers (two per column, 64 rows
    each) keep the up and down arm sums and write the output."""
    T, H, W = img.shape
    kx = _round16(k)
    tw, th = THR_TW, THR_TH
    nrs, rb = th + 2 * k, tw + 2 * kx
    seg_h = tw // (THR_THREADS // th)
    seg_v = th // (THR_THREADS // tw)
    out = np.zeros_like(img)
    for z in range(T):
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                gy = np.arange(y0 - k, y0 - k + nrs)[:, None]
                gx = np.arange(x0 - kx, x0 - kx + rb)[None, :]
                inside = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
                s = np.where(inside, img[z][np.clip(gy, 0, H - 1),
                                            np.clip(gx, 0, W - 1)],
                             0).astype(np.int64)
                # Row walkers: walker (row, seg) walks columns
                # [seg * seg_h, (seg + 1) * seg_h) of tile row `row`.
                hbits = np.zeros((th, tw), bool)
                for seg in range(tw // seg_h):
                    xs = seg * seg_h
                    row = s[k:k + th]
                    c = kx + xs
                    left = row[:, c - k:c].sum(1)
                    right = row[:, c + 1:c + k + 1].sum(1)
                    for x in range(xs, xs + seg_h):
                        c = kx + x
                        v = row[:, c]
                        t = k * v - C * k
                        hbits[:, x] = (left < t) & (right < t)
                        if x + 1 < xs + seg_h:
                            left += v - row[:, c - k]
                            right += row[:, c + k + 1] - row[:, c + 1]
                # Column walkers.
                for seg in range(th // seg_v):
                    ys = seg * seg_v
                    col = s[:, kx:kx + tw]
                    up = col[ys:ys + k].sum(0)
                    down = col[ys + k + 1:ys + 2 * k + 1].sum(0)
                    for y in range(ys, ys + seg_v):
                        v = col[k + y]
                        t = k * v - C * k
                        hit = ((up < t) & (down < t)) | hbits[y]
                        if noise_thresh >= 0:
                            hit |= v < noise_thresh
                        gy_, n = y0 + y, min(tw, W - x0)
                        if gy_ < H:
                            out[z, gy_, x0:x0 + n] = np.where(hit[:n], 255,
                                                              0)
                        if y + 1 < ys + seg_v:
                            up += v - col[y]
                            down += col[k + y + k + 1] - col[k + y + 1]
    return out


# ---- merge + open + prefix tail (lt_merge_open, lt_thr_merge_open's second
# launch, lt_open_prefix: open_tail_kernel) ----

BAND_ROWS = 32
OPEN_MAX_R = 31
_M32 = np.uint64(0xFFFFFFFF)
_POPC8 = np.array([bin(i).count("1") for i in range(256)], np.uint64)
# Bit b of a mask is set where bit j of b is: the column sum of a word's
# set bits is sum_j 2^j popc(m & mask_j).
_PLANE_MASKS = (0xAAAAAAAA, 0xCCCCCCCC, 0xF0F0F0F0, 0xFF00FF00, 0xFFFF0000)


def _popc(x):
    x = x.astype(np.uint64)
    return sum(_POPC8[(x >> np.uint64(8 * i)) & np.uint64(0xFF)]
               for i in range(4))


def _fsr(lo, hi, s):
    """__funnelshift_r: bits [s, s + 32) of hi:lo."""
    return (((hi << np.uint64(32)) | lo) >> np.uint64(s)) & _M32


def _fsl(lo, hi, s):
    """__funnelshift_l: bits [32 - s, 64 - s) of hi:lo."""
    return ((((hi << np.uint64(32)) | lo) << np.uint64(s)) >> np.uint64(32)
            & _M32)


def pack_words(rows: np.ndarray, fill: int) -> np.ndarray:
    """(n, W) bools as (n, ceil(W / 32)) words, bit b of word i column
    32 i + b; bits past W are ``fill``."""
    n, W = rows.shape
    nw = -(-W // 32)
    bits = np.full((n, 32 * nw), bool(fill))
    bits[:, :W] = rows
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    return (bits.reshape(n, nw, 32) * weights).sum(-1, dtype=np.uint64)


def window(l, c, r, lo, hi, op):
    """Bit j: op over bits j + lo .. j + hi of the 96-bit segment (l, c, r)
    around c, by the kernel's doubling steps."""
    n = hi - lo + 1
    a0, a1, a2 = l, c, r
    length = 1
    while length < n:
        s = length if 2 * length <= n else n - length
        b0, b1, b2 = _fsr(a0, a1, s), _fsr(a1, a2, s), a2 >> np.uint64(s)
        a0, a1, a2 = op(a0, b0), op(a1, b1), op(a2, b2)
        length += s
    return _fsl(a0, a1, -lo) if lo <= 0 else _fsr(a1, a2, lo)


def morph_words(src, row0, runs, op, init):
    """Each output word of rows row0 (SE row dy reads src row row0 + dy;
    src rows carry a pad word a side): op over the runs' windows."""
    nw = src.shape[1] - 2
    acc = np.full((len(row0), nw), init, np.uint64)
    for dy, (lo, hi) in runs:
        s = src[row0 + dy]
        acc = op(acc, window(s[:, :nw], s[:, 1:nw + 1], s[:, 2:], lo, hi, op))
    return acc


def packed_bits(m, j, shift):
    """Packed prefix contribution ((count * 32 j + column sum) << shift) +
    count of the set bits of words m in word columns j, mod 2^32."""
    n = _popc(m)
    pos = sum(np.uint64(1 << i) * _popc(m & np.uint64(mask))
              for i, mask in enumerate(_PLANE_MASKS))
    return (((n * np.uint64(32) * j + pos) << np.uint64(shift)) + n) & _M32


def open_tail_model(a, b=None, keep=None, k=5):
    """(binary, packed prefixes) of open((a | b) & keep) as open_tail_kernel
    computes them: BAND_ROWS-row bands of 32-pixel words, the input packed
    with 2r + 2r halo rows (1 outside: the erode's pad), the eroded rows
    (0 outside: the dilate's pad), the dilated rows, popcount prefixes."""
    T, H, W = a.shape
    runs = ellipse_runs(k)
    r = k // 2
    assert k % 2 == 1 and r <= OPEN_MAX_R
    nw = -(-W // 32)
    shift = (W + 1).bit_length()
    tail = np.uint64((1 << (W % 32)) - 1 if W % 32 else 0xFFFFFFFF)
    n_in, n_ero = BAND_ROWS + 4 * r, BAND_ROWS + 2 * r
    binary = np.zeros((T, H, W), np.uint8)
    pref = np.zeros((T, H, W + 1), np.int32)
    X = np.arange(W + 1)
    jx, below = X >> 5, (np.uint64(1) << (X & 31).astype(np.uint64)) - 1
    for z in range(T):
        merged = a[z] != 0
        if b is not None:
            merged |= b[z] != 0
        if keep is not None:
            merged &= keep[z] != 0
        for y0 in range(0, H, BAND_ROWS):
            gy = y0 - 2 * r + np.arange(n_in)
            inside = (gy >= 0) & (gy < H)
            in_bits = np.full((n_in, nw + 2), 0xFFFFFFFF, np.uint64)
            in_bits[inside, 1:nw + 1] = pack_words(merged[gy[inside]], 1)
            gy = y0 - r + np.arange(n_ero)
            inside = (gy >= 0) & (gy < H)
            e = morph_words(in_bits, np.arange(n_ero) + r, runs,
                            np.bitwise_and, 0xFFFFFFFF)
            e[:, nw - 1] &= tail
            ero = np.zeros((n_ero, nw + 2), np.uint64)
            ero[inside, 1:nw + 1] = e[inside]
            rows = min(BAND_ROWS, H - y0)
            dil = np.zeros((BAND_ROWS, nw + 1), np.uint64)
            dil[:rows, :nw] = morph_words(ero, np.arange(rows) + r, runs,
                                          np.bitwise_or, 0)
            dil[:rows, nw - 1] &= tail
            tot = packed_bits(dil, np.arange(nw + 1, dtype=np.uint64), shift)
            wpre = (np.cumsum(tot, 1) - tot) & _M32
            d = dil[:rows]
            bit = (d[:, np.arange(W) >> 5]
                   >> (np.arange(W) & 31).astype(np.uint64)) & np.uint64(1)
            binary[z, y0:y0 + rows] = np.where(bit == 1, 255, 0)
            p = (wpre[:rows, jx] + packed_bits(d[:, jx] & below,
                                               jx.astype(np.uint64), shift))
            pref[z, y0:y0 + rows] = (p & _M32).astype(np.uint32).view(np.int32)
    return binary, pref


# ---- probe 6's products (lt_sweep_dots: sweep_dots_kernel) ----

SD_STRIP, SD_K, SD_M, SD_WARPGROUPS = 32, 16, 64, 2
SD_BLOCKS, SD_BLOCK_STEP = 3, 8


def sweep_dots_tiles(cols, col0, kp, n, block) -> list:
    """The wgmma products sweep_dots_kernel issues, in its loop order:
    (strip, warpgroup, m tile, first K column, block j, first row n0 of the
    block, tile width nt).  Strip s takes its 16-column K steps inside
    [col0, col0 + kp); warpgroup g its m tiles g, g + 2, ...; each step
    every block's rows in tiles of nt (184 where it divides the block,
    else 8)."""
    nt = 184 if block % 184 == 0 else 8
    tiles = []
    for s in range(-(-cols // SD_STRIP)):
        c0 = s * SD_STRIP
        steps = [c0 + SD_K * q for q in range(SD_STRIP // SD_K)
                 if col0 <= c0 + SD_K * q and c0 + SD_K * (q + 1) <= col0 + kp]
        for g in range(SD_WARPGROUPS):
            for mt in range(g, n // SD_M, SD_WARPGROUPS):
                for k0 in steps:
                    for j in range(SD_BLOCKS):
                        for n0 in range(0, block, nt):
                            tiles.append((s, g, mt, k0, j, n0, nt))
    return tiles


def sweep_dots_products(scr: np.ndarray, tri: np.ndarray, tiles,
                        col0: int) -> np.ndarray:
    """Each frame's sum, in float64, of every tile's product: tri's K rows
    [k0, k0 + 16) - col0 and m tile's 64 columns (A, M-major) by the swept
    strip's block rows [8 j + n0, + nt) at those columns (B, K-major)."""
    total = np.zeros(scr.shape[0])
    for _, _, mt, k0, j, n0, nt in tiles:
        a = tri[k0 - col0:k0 - col0 + SD_K, SD_M * mt:SD_M * (mt + 1)]
        rows = SD_BLOCK_STEP * j + n0
        b = scr[:, rows:rows + nt, k0:k0 + SD_K]
        total += b.sum(1) @ a.sum(1)
    return total


# ---- adaptive mean threshold (lt_adaptive_mean: adaptive_mean_kernel) ----

AM_TW, AM_THREADS, AM_GUARD = 128, 256, 16
AM_SUM_PITCH = 2 * AM_TW + 8
AM_MAX_K = 127
AM_ROWS = (128, 64, 32, 16)


def adaptive_mean_rows(T: int, H: int, W: int, sms: int = 132) -> int:
    """The tile height the kernel's host picks: the tallest of AM_ROWS
    whose grid gives each of ``sms`` SMs a CTA, else the shortest."""
    cols = -(-W // AM_TW)
    for th in AM_ROWS:
        if T * cols * -(-H // th) >= sms:
            return th
    return AM_ROWS[-1]


def adaptive_mean_model(img: np.ndarray, k: int, C: int, th: int,
                        rng: np.random.Generator) -> np.ndarray:
    """cv2's MEAN_C threshold as adaptive_mean_kernel computes it with
    (th, 128) tiles: the staged plane (replicate-clamped, pitch an odd
    number of words, after a guard) in a buffer of random bytes; row
    walkers' uint16 sums started at the window of column -1 (its leaving
    byte may be the guard's or the row before's: it cancels); column
    walkers over quarter-height segments writing 0/255 in place (the last
    slide reads a spare row); the outputs copied out."""
    T, H, W = img.shape
    assert k % 2 == 1 and 1 <= k <= AM_MAX_K
    r = k // 2
    kx = _round16(r)
    ps = AM_TW + 2 * kx + 4
    assert (ps // 4) % 2 == 1
    rows = th + 2 * r
    area = k * k
    idelta = min(max(C, -256), 256)
    mul, off = 2 * area, 2 * area * idelta - area
    seg = th // (AM_THREADS // (AM_TW // 2))
    out = np.zeros_like(img)
    for z in range(T):
        for y0 in range(0, H, th):
            for x0 in range(0, W, AM_TW):
                buf = rng.integers(0, 256, AM_GUARD + rows * ps).astype(
                    np.int64)
                gy = np.clip(np.arange(y0 - r, y0 - r + rows), 0, H - 1)
                gx = np.clip(np.arange(x0 - kx, x0 + AM_TW + kx), 0, W - 1)
                plane = buf[AM_GUARD:].reshape(rows, ps)
                plane[:, :AM_TW + 2 * kx] = img[z][gy[:, None], gx[None, :]]
                flat = buf  # plane row i starts at AM_GUARD + i * ps
                base = AM_GUARD + np.arange(rows) * ps
                # Row walkers, all rows at once, one column a step.
                s = sum(flat[base + kx + j] for j in range(-r - 1, r))
                hs = np.zeros((rows, AM_TW), np.uint16)
                for c in range(AM_TW):
                    s = s + flat[base + kx + c + r] - flat[base + kx + c - 1 - r]
                    assert s.max() < 1 << 16
                    hs[:, c] = s
                # Column walkers: pairs of columns, segments of seg rows;
                # the last slide reads a spare row of random sums.
                hs = np.vstack([hs, rng.integers(0, 1 << 16, (1, AM_TW))
                                ]).astype(np.int64)
                for ys in range(0, th, seg):
                    v = hs[ys:ys + 2 * r + 1].sum(0)
                    for y in range(ys, ys + seg):
                        xs = plane[r + y, kx:kx + AM_TW]
                        plane[r + y, kx:kx + AM_TW] = np.where(
                            2 * v < mul * xs + off, 255, 0)
                        v = v + hs[y + 2 * r + 1] - hs[y]
                ys_, xs_ = min(th, H - y0), min(AM_TW, W - x0)
                out[z, y0:y0 + ys_, x0:x0 + xs_] = plane[
                    r:r + ys_, kx:kx + xs_]
    return out


# ---- fused channel stage (lt_channel_stage: channel_stage_kernel) ----

CS_THREADS, CS_SEG, CS_MAX_ROWS = 512, 32, 1024
CS_SMEM = 227 * 1024  # the H100's shared memory a block can opt in to
# (quads a thread holds, CTAs an SM, shared memory a CTA, the planner's
# weight of its accesses x 10): the kernel's kCsShapes.
CS_SHAPES = ((8, 1, CS_SMEM, 10), (6, 2, 110 * 1024, 13))


def cs_size(kt: int, kb: int, kn: int, tq: int, th: int) -> dict:
    """The kernel's sizes (cs_size in csrc/channel_stage.cu) of a tile of
    tq quads x th rows."""
    r = kt // 2
    rq = -(-r // 16)
    kbq, knq = -(-kb // 16), -(-kn // 16)
    p = dict(r=r, rq=rq, tq=tq, th=th, kb=kb, kn=kn, kbq=kbq,
             hy=max(kb + 2 * r, kn), hq=max(kbq + 2 * rq, knq))
    p["nrx"], p["nqx"] = th + 2 * p["hy"], tq + 2 * p["hq"]
    p["pd"] = 16 * (tq + 2 * kbq) + 4
    p["pn"] = 16 * (tq + 2 * knq) + 4
    p["hbp"] = 16 * tq // CS_SEG + 1
    p["bufs"] = 2 * 16 * (p["nrx"] * p["nqx"] + 2 * 3)
    p["smem"] = p["bufs"] + 4 * th * p["hbp"]
    return p


def cs_fits(kt, kb, kn, tq, th, shape=CS_SHAPES[0]) -> bool:
    p = cs_size(kt, kb, kn, tq, th)
    thd, tqd = th + 2 * kb, tq + 2 * p["kbq"]
    cap = shape[0] * CS_THREADS
    return (p["smem"] <= shape[2]
            and (thd + 2 * p["r"]) * (tqd + 2 * p["rq"]) <= cap
            and thd * tqd <= cap and (thd + 1) * p["pd"] <= p["bufs"]
            and (kn == 0
                 or (th + 2 * kn + 1) * p["pn"] <= 16 * p["nrx"] * p["nqx"]))


def cs_cost(kt, kb, kn, tq, th, H, W) -> int:
    p = cs_size(kt, kb, kn, tq, th)
    r, rq, n = p["r"], p["rq"], len(tophat_steps(kt))
    thd, tqd = th + 2 * kb, tq + 2 * p["kbq"]
    rows_e, nqe = thd + 2 * r, tqd + 2 * rq
    tw = 16 * tq
    nsy = -(-CS_THREADS // tw)

    def walks(k):
        return 6 * th * tw + 2 * k * (th * (tw // CS_SEG) + tw * nsy)

    tile = (6 * n * ((thd + 4 * r) * p["nqx"] + rows_e * nqe)
            + 2 * (2 * r + 1) * (rows_e * nqe + thd * tqd)
            + p["nrx"] * p["nqx"] + walks(kb) + (walks(kn) if kn else 0))
    return tile * -(-H // th) * -(-W // tw)


def cs_plan(kt, kb, kn, H, W, block=0) -> dict:
    """The kernel's tile and shape (cs_plan): for each shape and width,
    block 0 the fewest rows of tiles that fit, as even as they go, else
    block rows clamped to H and to what fits; of those the fewest
    estimated accesses, weighted by the shape."""
    best = None
    for shape in CS_SHAPES:
        for tq in (4, 8, 12, 16):
            fit = 0
            for h in range(1, CS_MAX_ROWS + 1):
                if not cs_fits(kt, kb, kn, tq, h, shape):
                    break
                fit = h
            if fit == 0:
                continue
            if block > 0:
                th = min(block, H, fit)
            else:
                th = -(-H // -(-H // fit))
            cost = cs_cost(kt, kb, kn, tq, th, H, W) * 10 // shape[3]
            if best is None or cost < best[0]:
                best = (cost, tq, th, shape)
    assert best is not None
    return {**cs_size(kt, kb, kn, best[1], best[2]), "shape": best[3]}


def _cross_walk_model(plane, cy, cx, th, tw, k, C, nthr):
    """Hits of cross_walk over a plane whose pixel (cy + y, cx + c) is the
    tile's (y, c): row walkers of CS_SEG columns, column walkers of
    ceil(th / nsy) rows, each with running arm sums."""
    t_off = C * k
    hbits = np.zeros((th, tw), bool)
    rows = cy + np.arange(th)
    for xs in range(0, tw, CS_SEG):
        c0 = cx + xs
        left = sum(plane[rows, c0 - j] for j in range(1, k + 1))
        right = sum(plane[rows, c0 + j] for j in range(1, k + 1))
        for x in range(CS_SEG):
            c = c0 + x
            v = plane[rows, c]
            t = k * v - t_off
            hbits[:, xs + x] = (left < t) & (right < t)
            left = left + v - plane[rows, c - k]
            right = right + plane[rows, c + k + 1] - plane[rows, c + 1]
    hit = np.zeros((th, tw), bool)
    nsy = -(-CS_THREADS // tw)
    segh = -(-th // nsy)
    cols = cx + np.arange(tw)
    for ys in range(0, th, segh):
        ye = min(ys + segh, th)
        up = sum(plane[cy + ys - j, cols] for j in range(1, k + 1))
        down = sum(plane[cy + ys + j, cols] for j in range(1, k + 1))
        for y in range(ys, ye):
            v = plane[cy + y, cols]
            t = k * v - t_off
            hit[y] = ((up < t) & (down < t)) | hbits[y] | (v < nthr)
            up = up + v - plane[cy + y - k, cols]
            down = (down + plane[cy + y + k + 1, cols]
                    - plane[cy + y + 1, cols])
    return hit


def _outside(H, W, gy0, gx0, rows, cols):
    gy = np.arange(gy0, gy0 + rows)[:, None]
    gx = np.arange(gx0, gx0 + cols)[None, :]
    return (gy < 0) | (gy >= H) | (gx < 0) | (gx >= W)


def channel_stage_model(img, kt, kb, C, noise=None, block=0, rng=None):
    """(th, keep) as channel_stage_kernel computes them with cs_plan's
    tiles: the staged plane (0 outside with the noise mask, whose reach is
    copied to a plane of odd-word pitch and walked for keep, then 255
    outside; 255 outside without it) in random buffers;
    the erode of the tophat region plus r, read from the plane at its
    offset; the eroded region (0 outside) as the dilate's source; the
    tophat plane x - open (0 outside, a random spare row and pad); its
    cross threshold."""
    T, H, W = img.shape
    kn, Cn, nthr = noise if noise else (0, 0, -1)
    p = cs_plan(kt, kb, kn, H, W, block)
    r, rq, tq, th, kbq = p["r"], p["rq"], p["tq"], p["th"], p["kbq"]
    hy, hq, nrx, nqx, pd = p["hy"], p["hq"], p["nrx"], p["nqx"], p["pd"]
    tw, steps = 16 * tq, tophat_steps(kt)
    thd, tqd = th + 2 * kb, tq + 2 * kbq
    nre, nqe = thd + 2 * r, tqd + 2 * rq
    size = 16 * nrx * nqx
    out = np.zeros_like(img)
    keep = np.zeros_like(img) if noise else None
    for z in range(T):
        x_img = img[z].astype(np.int64)
        for y0 in range(0, H, th):
            for x0 in range(0, W, tw):
                sy0, sx0 = y0 - hy, x0 - 16 * hq
                out_s = _outside(H, W, sy0, sx0, nrx, 16 * nqx)
                gy = np.clip(np.arange(sy0, sy0 + nrx), 0, H - 1)
                gx = np.clip(np.arange(sx0, sx0 + 16 * nqx), 0, W - 1)
                S = np.where(out_s, 0 if noise else 255,
                             x_img[gy[:, None], gx[None, :]])
                ys_, xs_ = min(th, H - y0), min(tw, W - x0)
                if noise:
                    knq, pn = -(-kn // 16), p["pn"]
                    Nz = rng.integers(0, 256, (th + 2 * kn + 1, pn))
                    c0 = 16 * (hq - knq)
                    Nz[:th + 2 * kn, :pn - 4] = S[hy - kn:hy + th + kn,
                                                  c0:c0 + pn - 4]
                    hit = _cross_walk_model(Nz, kn, 16 * knq, th, tw, kn, Cn,
                                            nthr)
                    keep[z, y0:y0 + ys_, x0:x0 + xs_] = np.where(
                        hit[:ys_, :xs_], 255, 0)
                    S = np.where(out_s, 255, S)
                bufs = [rng.integers(0, 256, size + 2 * GUARD).astype(
                    np.uint8) for _ in range(2)]
                bufs[0][GUARD:GUARD + size] = S.astype(np.uint8).reshape(-1)
                base = 16 * ((hy - kb - 2 * r) * nqx + hq - kbq - 2 * rq)
                acc = _morph(bufs, steps, np.minimum, nrx, 16 * nqx, r,
                             16 * rq, nre, 16 * nqe, 255, g=GUARD + base)
                e = np.where(_outside(H, W, y0 - kb - r,
                                      x0 - 16 * (kbq + rq), nre, 16 * nqe),
                             0, acc)
                bufs[0][GUARD:GUARD + nre * 16 * nqe] = e.astype(
                    np.uint8).reshape(-1)
                dil = _morph(bufs, steps, np.maximum, nre, 16 * nqe, r,
                             16 * rq, thd, 16 * tqd, 0).astype(np.int64)
                out_d = _outside(H, W, y0 - kb, x0 - 16 * kbq, thd, 16 * tqd)
                gy = np.clip(np.arange(y0 - kb, y0 - kb + thd), 0, H - 1)
                gx = np.clip(np.arange(x0 - 16 * kbq, x0 - 16 * kbq
                                       + 16 * tqd), 0, W - 1)
                D = rng.integers(0, 256, (thd + 1, pd))
                D[:thd, :16 * tqd] = np.where(
                    out_d, 0, x_img[gy[:, None], gx[None, :]] - dil)
                hit = _cross_walk_model(D, kb, 16 * kbq, th, tw, kb, C, -1)
                out[z, y0:y0 + ys_, x0:x0 + xs_] = np.where(
                    hit[:ys_, :xs_], 255, 0)
    return out if keep is None else (out, keep)


# ---- the shift chains (lt_shift_chain, lt_shift_chain_2d) ----

CHAIN_REGS = 40  # kRegs: slots a lane holds


def chain_orbits(L: int, s: int, boundary: str, passes=None) -> dict:
    """The kernel's orbit plan of one line (make_orbits, OrbitCursor and
    orbit_src in csrc/shift_chain.cuh): ``pos[lane, r]``, the line position
    slot r of the lane holds (-1: padding), ``end[lane, r]``, whether the
    slot is its orbit's last (it reads the fill, or for a roll its cycle's
    first slot, instead of the next slot), ``src[lane]``, the lane whose
    register 0 the lane's last register reads (a shuffle), ``reads``, the
    position each slot's neighbour is (``L`` for the fill), and ``real``,
    the slots written back.  A roll of at most as many ``passes`` as its
    cycles' padding slots (each cycle on ceil(n / 40) lanes, or on 32 / g
    where that gives it the padding) is ``periodic``: the padding
    continues each cycle (slot j holds element j mod n) and no slot is an
    end."""
    R = CHAIN_REGS
    roll = boundary == "circular" or s == 0
    periodic = False
    if roll:
        n = L // np.gcd(s, L)
        g = L // n
        lpc = -(-n // R)
        if passes is not None:
            # the cycles widened to a warp's lanes where that gives them
            # the padding
            wide = 32 // g
            if passes <= lpc * R - n:
                periodic = True
            elif passes <= wide * R - n and wide >= lpc:
                lpc, periodic = wide, True
        lanes = g * lpc
    else:
        sp = min(s, L)
        a, b = divmod(L, sp)
        lanes = -(-L // R)
    pos = np.full((lanes, R), -1, np.int64)
    end = np.zeros((lanes, R), bool)
    real = np.zeros((lanes, R), bool)
    src = np.arange(lanes)
    for lane in range(lanes):
        for r in range(R):
            if roll:
                c, k = divmod(lane, lpc)
                j = k * R + r
                if j < n or periodic:
                    pos[lane, r] = (c - j * s) % L
                    end[lane, r] = j == n - 1 and not periodic
                    real[lane, r] = j < n
            else:
                q = lane * R + r
                if q >= L:
                    continue
                head = b * (a + 1)
                if q < head:
                    orb, j = divmod(q, a + 1)
                    length = a + 1
                else:
                    orb, j = divmod(q - head, a)
                    orb += b
                    length = a
                pos[lane, r] = orb + j * sp
                end[lane, r] = j == length - 1
                real[lane, r] = True
        if roll:
            c, k = divmod(lane, lpc)
            src[lane] = c * lpc if k == lpc - 1 else lane + 1
        else:
            src[lane] = min(lane + 1, lanes - 1)
    # What each slot reads: the next slot, the next lane's register 0, or
    # at an orbit's end the fill / its cycle's first slot.
    nxt = np.concatenate([pos[:, 1:], pos[src, :1]], axis=1)
    wrap = pos[src, :1] if roll else np.full((lanes, 1), L)
    reads = np.where(end, np.broadcast_to(wrap, pos.shape), nxt)
    return {"pos": pos, "end": end, "src": src, "lanes": lanes,
            "roll": roll, "reads": reads, "real": real,
            "periodic": periodic}


def chain_mode(v, L: int, passes=None) -> str:
    """The kernel's mode for a variant's lines (line_plan): "plain" for
    the packed-u16 body, for slices whose orbits are shorter than a lane's
    run (a lane would hold two orbit ends), for lines whose orbits need
    more than one warp's 32 lanes, and for rolls whose cycles need more
    than twice the lanes of the plain order (half or more of the slots
    padding); else "orbit", in one warp."""
    if v.body == "packed":
        return "plain"
    s = v.shifts[0] % L if v.boundary == "circular" else v.shifts[0]
    plan = chain_orbits(L, s, v.boundary, passes)
    plain_lanes = -(-L // CHAIN_REGS)
    if not plan["roll"] and L // min(s, L) < CHAIN_REGS:
        return "plain"
    if plan["lanes"] > 32 or plan["lanes"] > 2 * plain_lanes:
        return "plain"
    return "orbit"


def _chain_body(v, x, a, b=None):
    """One pass of the variant's body on slot values x with neighbours a
    (and b), in the dtype's arithmetic (int64 values wrapped, as the twin;
    bf16 and f32 tensors)."""
    from lane_tracker_tpu_torch.kernels import shift_chain as sc

    wrap = lambda t: sc._wrap(t, v.dtype)  # noqa: E731
    if v.body == "add":
        return wrap(x + a)
    if v.body == "min":
        return torch.minimum(x, a)
    if v.body == "max":
        return torch.maximum(x, a)
    if v.body == "packed":
        return wrap(wrap(x + ((x >> 16) | wrap(b << 16))) + a)
    if v.body == "min_mul_max":
        return torch.maximum(torch.minimum(x, a),
                             x * sc._const(v.consts[0], x, v))
    raise ValueError(v.body)


def chain_model(x: torch.Tensor, v, k: int) -> torch.Tensor:
    """lt_shift_chain's line kernel in slots: each line along the variant's
    axis gathered into the orbit plan's slots (or plain order), every pass
    a shift by one slot (the next register, the ``src`` lane's register 0
    at a lane's end, the fill or the cycle's first slot at an orbit's end),
    then scattered back.  Padding slots start as 0 and are never written
    back.  Elementwise bodies are the twin's passes."""
    from lane_tracker_tpu_torch.kernels import shift_chain as sc

    if v.boundary is None:
        return sc.shift_chain_plain(x, v, k)
    axis = v.axis
    lines = (x if axis == 1 else x.t()).contiguous()
    lines = lines.long() if v.dtype in sc._INT_BITS else lines
    L = lines.shape[1]
    fill = lines.new_full((), v.fill)
    out = lines.clone()
    passes = v.n_passes(k)
    if chain_mode(v, L, passes) == "plain":
        # plain order through the shared buffers: a roll reads p - s (mod
        # L), a slice p + s or the fill
        q = torch.arange(L)
        y = lines
        for _ in range(passes):
            if v.boundary == "circular":
                a = y[:, (q - v.shifts[0] % L) % L]
                b = (y[:, (q - v.shifts[1] % L) % L] if v.body == "packed"
                     else None)
            else:
                s = v.shifts[0]
                a = torch.where(q + s < L, y[:, (q + s).clamp(max=L - 1)],
                                fill)
                b = None
            y = _chain_body(v, y, a, b)
        return (y if axis == 1 else y.t()).to(x.dtype).contiguous()
    s = v.shifts[0] % L if v.boundary == "circular" else v.shifts[0]
    plan = chain_orbits(L, s, v.boundary, passes)
    pos = torch.from_numpy(plan["pos"])
    end = torch.from_numpy(plan["end"])
    src = torch.from_numpy(plan["src"])
    slots = torch.where(pos >= 0, lines[:, pos.clamp(min=0)],
                        lines.new_zeros(()))  # (lines, lanes, R)
    for _ in range(passes):
        sh = slots[:, src, 0]  # each lane's shuffle of register 0
        w = sh if plan["roll"] else fill.expand_as(sh)
        nxt = torch.cat([slots[:, :, 1:], sh[:, :, None]], dim=2)
        wfull = w[:, :, None].expand_as(slots)
        slots = _chain_body(v, slots, torch.where(end, wfull, nxt))
    real = torch.from_numpy(plan["real"])
    out[:, pos[real]] = slots[:, real]
    return (out if axis == 1 else out.t()).to(x.dtype).contiguous()


CHAIN2D_MAX_SPLIT = 48
CHAIN2D_SMEM = 227 * 1024
CHAIN2D_STEPS = 4  # k2dSteps: outer steps a launch of lt_shift_chain_2d


def chain2d_col0(t: int, sub: int, a1: int, a2: int) -> int:
    """First exact region column after sub-step ``sub`` (0 or 1: the two
    column rolls) of step t, kept even (chain2d_col0)."""
    c = 0
    for i in range(t + 1):
        c = (c + a1 + 1) & ~1
        if i == t and sub == 0:
            return c
        c = (c + a2 + 1) & ~1
    return c


def chain2d_tiles(H: int, W: int, m: int, a1: int, a2: int, b1: int,
                  b2: int, sms: int = 132) -> dict:
    """The host's plan of one launch of m steps (chain2d_plan): of the
    ny x nx grids, the one whose busiest SM holds the least region area
    within a CTA's shared memory (two region buffers for the shifts 3 and
    6 on both axes, else three); ``tiles`` lists each CTA's (row, column)
    origin."""
    bufs = 2 if (a1, a2, b1, b2) == (3, 6, 3, 6) else 3
    col0 = chain2d_col0(m - 1, 1, a1, a2)
    best = None
    for ny in range(1, min(CHAIN2D_MAX_SPLIT, H) + 1):
        th = -(-H // ny)
        if ny > 1 and -(-H // th) != ny:
            continue
        for nx in range(1, min(CHAIN2D_MAX_SPLIT, W) + 1):
            tw = -(-W // nx)
            if nx > 1 and -(-W // tw) != nx:
                continue
            rh = th + m * (b1 + b2)
            rww = (col0 + tw + 1) // 2
            smem = bufs * rh * rww * 4
            if smem > CHAIN2D_SMEM:
                continue
            cost = -(-(ny * nx) // sms) * rh * rww
            if best is None or cost < best["cost"]:
                best = {"cost": cost, "th": th, "tw": tw, "rh": rh,
                        "rww": rww, "col0": col0, "smem": smem,
                        "tiles": [(i * th, j * tw) for i in range(ny)
                                  for j in range(nx)]}
    return best


def chain2d_model(x: torch.Tensor, outer: int, m: int, shifts, rng,
                  sms: int = 132) -> torch.Tensor:
    """lt_shift_chain_2d in numpy-indexed bf16: launches of at most m
    steps; each tile stages its region (rows and columns below the tile by
    the halo, indices modulo the block), runs the sub-steps over the parts
    whose inputs are exact (the kernel's row and even-column starts), with
    the p and q buffers starting as random bits, and writes its outputs."""
    H, W = x.shape
    a1, a2 = (s % W for s in shifts)
    b1, b2 = (s % H for s in shifts)
    db = b1 + b2
    y = x
    done = 0
    while done < outer:
        steps = min(m, outer - done)
        plan = chain2d_tiles(H, W, steps, a1, a2, b1, b2, sms)
        nxt = torch.empty_like(y)
        rh, rw = plan["rh"], 2 * plan["rww"]
        for r0, c0 in plan["tiles"]:
            rows = (r0 - steps * db + np.arange(rh)) % H
            cols = (c0 - plan["col0"] + np.arange(rw)) % W
            X = y[torch.from_numpy(rows)][:, torch.from_numpy(cols)].clone()
            garbage = lambda: torch.from_numpy(  # noqa: E731
                rng.integers(0, 1 << 16, (rh, rw), np.uint16).view(
                    np.int16).copy()).view(torch.bfloat16)
            P, Q = garbage(), garbage()
            cw = 0
            for t in range(steps):
                rv = t * db
                c1 = (cw + a1 + 1) & ~1
                c2 = (c1 + a2 + 1) & ~1
                P[rv:, c1:] = torch.minimum(X[rv:, c1:], X[rv:, c1 - a1:rw - a1])
                Q[rv:, c2:] = torch.minimum(P[rv:, c2:], P[rv:, c2 - a2:rw - a2])
                P[rv + b1:, c2:] = torch.maximum(Q[rv + b1:, c2:],
                                                 Q[rv:rh - b1, c2:])
                X[rv + db:, c2:] = X[rv + db:, c2:] - torch.maximum(
                    P[rv + db:, c2:], P[rv + b1:rh - b2, c2:])
                cw = c2
            th, tw = min(plan["th"], H - r0), min(plan["tw"], W - c0)
            nxt[r0:r0 + th, c0:c0 + tw] = X[steps * db:steps * db + th,
                                            plan["col0"]:plan["col0"] + tw]
        y = nxt
        done += steps
    return y.clone()


# ---- probe 11's in-tile gather (lt_tile_gather: tile_gather_kernel) ----

GATHER_TILE = (8, 128)
GATHER_LANES = 32
LOW7 = 0x7F7F7F7F
# The shapes (whole numbers of tiles) and chain lengths the design test and
# the card's tests hold the kernel to.
GATHER_SHAPES = ((8, 128), (128, 1280), (40, 384))
GATHER_REPS = (0, 1, 16, 64)


def byte_perm(x: np.ndarray, y: np.ndarray, s) -> np.ndarray:
    """``__byte_perm(x, y, s)`` on uint32 arrays: byte n of the result is
    byte ``(s >> 4n) & 7`` of the eight bytes x (0-3) then y (4-7)."""
    x, y = np.broadcast_arrays(x, y)
    eight = y.astype(np.uint64) << np.uint64(32) | x
    s = np.asarray(s, np.uint64)
    out = np.zeros(x.shape, np.uint32)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(7)
        byte = (eight >> (np.uint64(8) * sel)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * n)
    return out


def shfl(v: np.ndarray, src_lane: np.ndarray) -> np.ndarray:
    """``__shfl_sync(full, v, src_lane)`` on (..., 32) lanes."""
    return np.take_along_axis(v, src_lane.astype(np.int64), -1)


def pair_sel(b0, b1):
    return (np.asarray(b0, np.uint32)
            | (np.uint32(4) + np.asarray(b1, np.uint32)) << np.uint32(4))


def gather4(x0, x1, x2, x3, a, b):
    return byte_perm(byte_perm(x0, x1, a), byte_perm(x2, x3, b), 0x5410)


def _bytes_word(vals, axis):
    """Pack the low 7 bits of 4 values along ``axis`` into uint32 words,
    value k in byte k."""
    vals = np.moveaxis(np.asarray(vals, np.int64) & 0x7F, axis, 0)
    out = np.zeros(vals.shape[1:], np.uint32)
    for k in range(4):
        out |= vals[k].astype(np.uint32) << np.uint32(8 * k)
    return out


def _unbytes(word, k):
    return ((word >> np.uint32(8 * k)) & np.uint32(0xFF)).astype(np.int32)


def g3_copy_at(si: np.ndarray) -> np.ndarray:
    """G3's sublane gather: for (..., 4, 32) sublane indices (slot j, lane
    l; read modulo the tile), the byte of the CTA's shared copy that lane l
    reads for column l + 32 j of its row, 4 (32 (si & 7) + l) + j."""
    L = GATHER_LANES
    slot = np.arange(si.shape[-2])[:, None]
    return ((si & (GATHER_TILE[0] - 1)) * L + np.arange(L)) * 4 + slot


def gather_inputs(shape, seed, wide=False):
    """src, li, si (H, W) int32.  ``wide``: src anywhere in int32 (near its
    limits too) and indices with bits above the tile."""
    rng = np.random.default_rng(seed)
    if wide:
        src = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
        src.flat[::7] = 2 ** 31 - 1 - rng.integers(0, 300, src.flat[::7].size)
        src.flat[3::7] = -2 ** 31 + rng.integers(0, 300, src.flat[3::7].size)
        li = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
        si = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
    else:
        src = rng.integers(0, 2 ** 20, shape)
        li = rng.integers(0, GATHER_TILE[1], shape)
        si = rng.integers(0, GATHER_TILE[0], shape)
    return tuple(a.astype(np.int32) for a in (src, li, si))


def tile_gather_model(src: np.ndarray, li: np.ndarray, si: np.ndarray,
                      op: str, reps: int) -> np.ndarray:
    """``lt_tile_gather`` as its kernel runs it, on (H, W) int32 numpy
    arrays: the low 7 bits a byte, four bytes a word; B0 and G2 a thread a
    column (rows 0-3, 4-7 in two words, G2 one byte_perm a word), G1 a warp
    a row (lane l the columns l + 32 j as byte j, four shuffles and three
    byte_perms a word), G3 G1's warps, a row each, writing their rows to a
    CTA's shared copy (little-endian bytes), then G2 one byte of the copy
    an element."""
    H, W = src.shape
    th, tw = GATHER_TILE
    L = GATHER_LANES
    slots = tw // L
    if op in ("B0_plain_add", "G2_sublane_gather"):
        # (H/8, 8, W): band, row in the tile, column (one thread each)
        s = src.reshape(H // th, th, W)
        c = si.reshape(H // th, th, W) & (th - 1)
        s_w = [_bytes_word(s[:, 4 * h:4 * h + 4], 1) for h in (0, 1)]
        sel = [np.zeros((H // th, W), np.uint32) for _ in (0, 1)]
        for r in range(th):
            sel[r >> 2] |= c[:, r].astype(np.uint32) << np.uint32(4 * (r & 3))
        p = [np.zeros((H // th, W), np.uint32) for _ in (0, 1)]
        for _ in range(reps):
            lo = (s_w[0] + p[0]) & np.uint32(LOW7)
            hi = (s_w[1] + p[1]) & np.uint32(LOW7)
            if op == "G2_sublane_gather":
                p = [byte_perm(lo, hi, sel[0]), byte_perm(lo, hi, sel[1])]
            else:
                p = [lo, hi]
        out = np.stack([_unbytes(p[r >> 2], r & 3) for r in range(th)], 1)
        return out.reshape(H, W)
    # (H, W/128, 4, 32): row, tile column, slot j, lane l = column l + 32 j
    s = src.reshape(H, W // tw, slots, L)
    c = li.reshape(H, W // tw, slots, L) & (tw - 1)
    frm, pick = c & (L - 1), c >> 5
    s_w = _bytes_word(s, 2)  # (H, W/128, 32): a word a lane and row
    a = pair_sel(pick[:, :, 0], pick[:, :, 1])
    b = pair_sel(pick[:, :, 2], pick[:, :, 3])

    def lane_gather(p):
        v = (s_w + p) & np.uint32(LOW7)
        return gather4(*(shfl(v, frm[:, :, j]) for j in range(slots)), a, b)

    p = np.zeros_like(s_w)
    if op == "G1_lane_gather":
        for _ in range(reps):
            p = lane_gather(p)
        out = np.stack([_unbytes(p, j) for j in range(slots)], 2)
        return out.reshape(H, W)
    assert op == "G3_2d_gather", op
    # warp r of each (band, tile column) CTA holds row r; the shared copy's
    # byte 4 (32 r + l) + j holds column l + 32 j of row r
    at = g3_copy_at(si.reshape(H, W // tw, slots, L))  # (H, W/128, 4, 32)
    at = at.reshape(H // th, th, W // tw, slots, L).transpose(0, 2, 1, 3, 4)
    for _ in range(reps):
        rows = lane_gather(p)
        # (H/8, W/128, 8 rows x 32 lanes x 4 bytes): the CTA's copy
        copy = np.ascontiguousarray(
            rows.reshape(H // th, th, W // tw, L).transpose(0, 2, 1, 3))
        copy = copy.view("<u1").reshape(H // th, W // tw, 1, th * L * 4)
        got = np.take_along_axis(copy, at.reshape(H // th, W // tw, th,
                                                  slots * L), -1)
        got = got.reshape(H // th, W // tw, th, slots, L).astype(np.uint32)
        p = sum(got[:, :, :, j] << np.uint32(8 * j) for j in range(slots))
        p = p.transpose(0, 2, 1, 3).reshape(H, W // tw, L)
    out = np.stack([_unbytes(p, j) for j in range(slots)], 2)
    return out.reshape(H, W)
