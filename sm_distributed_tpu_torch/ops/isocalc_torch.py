"""Batched device-side gaussian blur -> centroid detection.

Port of ``sm_distributed_tpu/ops/isocalc_jax.py``.  The isotope cold
path's post-convolution math — blur the fine structure at instrument sigma,
find local maxima, parabolic-refine the top ``n_peaks`` — runs vectorized
over a packed batch of fine-structure SEGMENTS on a torch device.

Formulation (dense, not scatter): windowed fine-structure states cluster
at isotope spacings (~1/|z| Da) while the blur support is only 5*sigma, so
each ion's profile decomposes into <= n_peaks+4 short independent segments
(``ops.isocalc.fine_structure_segments``).  Per segment the profile is
evaluated densely::

    profile[l] = sum_s ab[s] * exp(-((l*step - m_rel[s]) / sigma)^2 / 2)

— elementwise ops and, for the rare heavy buckets, one batched matmul; no
scatter.

Batching is over SEGMENTS, not ions: segments are flattened across the ion
batch and grouped by their OWN state-count bucket, so a light 10-state
segment never pays a heavy neighbor's padding.  The per-batch row count
scales inversely with the state bucket so the dense (B, LC, S) block stays
~50 MB.

All device math is f32 in segment-local coordinates (range < 0.16 Da, so
f32 carries ~1e-8 Da resolution); absolute m/z assembly, cross-segment
top-k selection, and intensity normalization happen on the host in f64
(vectorized numpy, the JAX package's code).

Parity contract: the JAX package's (ulp(128) on the stage's outputs; the
patterns agree with the NumPy oracle ``isocalc.centroids`` to ~3e-7 Da in
m/z and ~1e-5 in normalized intensity), NOT bit-exactly — device-mode
caches live under a separate parameter key.  Ties among candidate maxima
go to the lower grid index, as ``jax.lax.top_k`` orders them.
Determinism: each segment's result depends only on its own (state-bucket)
padded row, so the same ion produces the same bits whichever chunk or batch
it rides in (the parallel==serial guarantee).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..analysis.numerics import numerics_surface
from .isocalc import SEGMENT_GRID_CAP

# Numerics contract (analysis/numerics.py), the JAX package's
# ``ops/isocalc_jax.py`` ``run``: the blur and centroid outputs within 128
# ulp of the JAX package's kernel (indices and fallbacks exact).
NUMERICS = numerics_surface(__name__, {
    "blur_centroid":
        "contract=ulp(128); test=tests/test_torch_isocalc_device.py::"
        "test_blur_centroid_matches_jax_kernel",
})

# per-segment state-count buckets, finer at the small end where the
# distribution mass lives (per-segment states p50=10, p90=28 on the full-DB
# corpus): exp cost is linear in the bucket
_STATE_BUCKETS = (4, 8, 12, 16, 24, 32, 48, 64, 128, 256, 512)
# per-segment grid-length buckets: a typical isotope cluster needs ~1050
# points (5-sigma support + a few-mDa span)
_GRID_BUCKETS = (1152, SEGMENT_GRID_CAP)
# dense-block budget: rows per batch = max(16, _BLOCK_ROWS // bucket), so
# the (B, LC, S) f32 block stays ~50 MB
_BLOCK_ROWS = 8192


def _state_bucket(n: int) -> int:
    for b in _STATE_BUCKETS:
        if n <= b:
            return b
    return _STATE_BUCKETS[-1]


def _grid_bucket(npts: int) -> int:
    for b in _GRID_BUCKETS:
        if npts <= b:
            return b
    return _GRID_BUCKETS[-1]


def blur_centroid(m_rel: torch.Tensor, ab: torch.Tensor,
                  seg_len: torch.Tensor, *, lc: int, k: int, step: float,
                  sigma: float, pad: float) -> tuple[torch.Tensor, ...]:
    """Per-segment blur -> centroid of one packed block (the JAX package's
    ``_kernel``), on the block's device.

    ``m_rel``, ``ab``: (B, Sc) f32 state positions and abundances (padding:
    m_rel huge, ab 0); ``seg_len``: (B,) int32 grid length per segment.
    Returns ``(v, li, y0, y1, y2, gm, fb)``: the top ``k`` candidate maxima
    (value, grid index; -1 where none) with their parabola neighbours, and
    the profile argmax (clipped to the interior) with its neighbours, the
    fallback of a segment without a local maximum."""
    b, sc = m_rel.shape
    dev = m_rel.device
    inv2s2 = float(np.float32(-0.5 / (sigma * sigma)))
    win = float(np.float32(pad + step))
    stepf = float(np.float32(step))
    g = torch.arange(lc, dtype=torch.float32, device=dev) * stepf    # (LC,)
    # truncation mirrors the oracle's per-state windows (|x| > pad
    # contributes zero there; the half-step slack admits at most one extra
    # ~e^-12.5 tail point per edge)
    if sc <= 64:
        # per-state accumulation over the (B, LC) profile, states in order
        p = torch.zeros((b, lc), dtype=torch.float32, device=dev)
        for s in range(sc):
            x = g[None, :] - m_rel[:, s: s + 1]
            p = p + ab[:, s: s + 1] * torch.where(
                x.abs() <= win, torch.exp(inv2s2 * x * x), 0.0)
    else:
        # rare huge-cluster buckets: the dense (B, LC, Sc) block
        x = g[None, :, None] - m_rel[:, None, :]
        w = torch.where(x.abs() <= win, torch.exp(inv2s2 * x * x), 0.0)
        p = torch.einsum("bls,bs->bl", w, ab)
    # strict local maxima, excluding segment-boundary points (the oracle's
    # `interior` mask) and the padded tail
    larange = torch.arange(lc, dtype=torch.int32, device=dev)
    interior = ((larange[None, :] >= 1)
                & (larange[None, :] < seg_len[:, None] - 1))
    mids = ((p[:, 1:-1] >= p[:, :-2]) & (p[:, 1:-1] > p[:, 2:])
            & interior[:, 1:-1])
    cand = torch.where(mids, p[:, 1:-1], -1.0)
    # top k, ties to the lower index (jax.lax.top_k's order; torch.topk
    # leaves ties unordered): a stable descending sort
    v, li = torch.sort(cand, dim=1, descending=True, stable=True)
    v, li = v[:, :k], li[:, :k] + 1
    y0, y1, y2 = (p.gather(1, li - 1), p.gather(1, li),
                  p.gather(1, li + 1))
    # fallback support: the profile argmax (the first maximum, as in the
    # oracle: "no local max -> argmax"), with its parabola neighbours
    gm = torch.clamp(torch.argmax(p, dim=1), 1, lc - 2)
    fb = torch.stack([p.gather(1, gm[:, None])[:, 0],
                      p.gather(1, gm[:, None] - 1)[:, 0],
                      p.gather(1, gm[:, None] + 1)[:, 0]], dim=1)
    return (v, li.to(torch.int32), y0, y1, y2, gm.to(torch.int32), fb)


def _parabola(y0, y1, y2, li):
    """Vectorized sub-grid refinement — same arithmetic as the oracle.
    Returns (height, grid_offset) f64 arrays."""
    y0 = y0.astype(np.float64)
    y1 = y1.astype(np.float64)
    y2 = y2.astype(np.float64)
    denom = y0 - 2.0 * y1 + y2
    delta = np.where(np.abs(denom) > 0,
                     0.5 * (y0 - y2) / np.where(denom == 0, 1.0, denom), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    height = y1 - 0.25 * (y0 - y2) * delta
    return height, li.astype(np.float64) + delta


class DeviceBlurCentroid:
    """Packed-segment blur->centroid (see module doc).

    One instance per isotope-generation parameter set and device.
    ``centroid_batch`` consumes the per-ion segment lists produced by
    ``isocalc.fine_structure_segments`` and returns oracle-compatible
    ``(mzs, ints)`` f64 pairs (m/z ascending, intensities normalized to
    max=100).  ``stats`` counts the calls, ions, segments, distinct
    (state, grid) buckets and blocks and the stage's seconds (on a CUDA
    device also its device seconds, by CUDA events around each block's
    work)."""

    def __init__(self, charge: int, isocalc_sigma: float,
                 isocalc_pts_per_mz: int, n_peaks: int,
                 device: str | torch.device = "cuda"):
        from ..models.msm_torch import resolve_device

        self.charge = charge
        self.sigma = float(isocalc_sigma)
        self.step = 1.0 / isocalc_pts_per_mz
        self.pad = 5.0 * self.sigma
        self.n_peaks = n_peaks
        self.c_cap = n_peaks + 4
        self.lc = SEGMENT_GRID_CAP
        self.device = resolve_device(device)
        self._stats_lock = threading.Lock()
        self._buckets: set[tuple[int, int]] = set()
        self.stats = {"calls": 0, "ions": 0, "segments": 0, "blocks": 0,
                      "buckets": 0, "seconds": 0.0,
                      "device_s": 0.0 if self.device.type == "cuda" else None}

    def centroid_batch(
        self, seg_lists: list[list[tuple[float, np.ndarray, np.ndarray, int]]]
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Blur + centroid every ion; returns one (mzs, ints) per input."""
        t0 = time.perf_counter()
        k = self.n_peaks
        # flatten (ion, position) -> segment; group by per-SEGMENT bucket
        seg_ion: list[int] = []
        seg_pos: list[int] = []
        seg_lo: list[float] = []
        segs: list[tuple[np.ndarray, np.ndarray, int]] = []
        for i, sl in enumerate(seg_lists):
            for ci, (lo, m, a, npts) in enumerate(sl):
                seg_ion.append(i)
                seg_pos.append(ci)
                seg_lo.append(lo)
                segs.append((m, a, npts))
        n_seg = len(segs)
        v = np.empty((n_seg, k), np.float32)
        li = np.empty((n_seg, k), np.int32)
        y0 = np.empty((n_seg, k), np.float32)
        y1 = np.empty((n_seg, k), np.float32)
        y2 = np.empty((n_seg, k), np.float32)
        gm = np.empty(n_seg, np.int32)
        fb = np.empty((n_seg, 3), np.float32)

        by_bucket: dict[tuple[int, int], list[int]] = {}
        for si, (m, _a, npts) in enumerate(segs):
            key = (_state_bucket(m.size), _grid_bucket(npts))
            by_bucket.setdefault(key, []).append(si)
        n_blocks, device_s = 0, 0.0
        cuda = self.device.type == "cuda"
        for (sc, lc), idxs in sorted(by_bucket.items()):
            b = max(16, _BLOCK_ROWS // sc)
            for s in range(0, len(idxs), b):
                group = idxs[s: s + b]
                m_rel = np.full((b, sc), 1e6, np.float32)
                ab = np.zeros((b, sc), np.float32)
                ln = np.zeros(b, np.int32)
                for bi, si in enumerate(group):
                    m, a, npts = segs[si]
                    m_rel[bi, : m.size] = m
                    ab[bi, : a.size] = a
                    ln[bi] = npts
                # smlint: host-sync-ok[a block's segments go up for its stage]
                args = [torch.from_numpy(x).to(self.device)
                        for x in (m_rel, ab, ln)]
                if cuda:
                    ev0 = torch.cuda.Event(enable_timing=True)
                    ev1 = torch.cuda.Event(enable_timing=True)
                    ev0.record()
                outs = blur_centroid(*args, lc=lc, k=k, step=self.step,
                                     sigma=self.sigma, pad=self.pad)
                if cuda:
                    ev1.record()
                g = np.asarray(group)
                for dst, src in zip((v, li, y0, y1, y2, gm, fb), outs):
                    # smlint: host-sync-ok[the host finishes the peaks in f64]
                    dst[g] = src.cpu().numpy()[: len(group)]
                if cuda:
                    # smlint: host-sync-ok[device time, read after the fetch]
                    device_s += ev0.elapsed_time(ev1) / 1e3
                n_blocks += 1
        seg_maps = (np.asarray(seg_ion, np.int64),
                    np.asarray(seg_pos, np.int64),
                    np.asarray(seg_lo, np.float64))
        out = self._assemble(seg_lists, *seg_maps, v, li, y0, y1, y2, gm, fb)
        with self._stats_lock:
            st = self.stats
            st["calls"] += 1
            st["ions"] += len(seg_lists)
            st["segments"] += n_seg
            st["blocks"] += n_blocks
            self._buckets.update(by_bucket)
            st["buckets"] = len(self._buckets)
            st["seconds"] += time.perf_counter() - t0
            if cuda:
                st["device_s"] += device_s
        return out

    def _assemble(self, seg_lists, seg_ion, seg_pos, seg_lo,
                  v, li, y0, y1, y2, gm, fb):
        """Vectorized host f64 finish: parabolic refinement, cross-segment
        top-k by intensity, m/z-ascending order, max-100 normalization —
        the exact oracle conventions, no per-ion Python loop."""
        k = self.n_peaks
        n_ions = len(seg_lists)
        h, off = _parabola(y0, y1, y2, li)                     # (Nseg, k)
        mz = seg_lo[:, None] + self.step * off
        valid = v > 0.0
        # per-ion candidate matrices (n_ions, c_cap*k), -inf padded
        cand_h = np.full((n_ions, self.c_cap * k), -np.inf)
        cand_mz = np.zeros((n_ions, self.c_cap * k))
        cols = (seg_pos[:, None] * k + np.arange(k)[None, :])  # (Nseg, k)
        rows = np.broadcast_to(seg_ion[:, None], cols.shape)
        cand_h[rows, cols] = np.where(valid, h, -np.inf)
        cand_mz[rows, cols] = mz
        # top n_peaks by height (descending), then m/z-ascending
        order = np.argsort(-cand_h, axis=1, kind="stable")[:, :k]
        rix = np.arange(n_ions)[:, None]
        sel_h = cand_h[rix, order]
        sel_mz = cand_mz[rix, order]
        n_valid = (sel_h > -np.inf).sum(axis=1)
        # fallback (oracle: "no local max -> argmax"): best segment by
        # profile max, parabola at its argmax
        none = n_valid == 0
        if none.any():
            seg_best = np.full(n_ions, -1, np.int64)
            best_val = np.full(n_ions, -np.inf)
            np.maximum.at(best_val, seg_ion, fb[:, 0].astype(np.float64))
            match = fb[:, 0].astype(np.float64)[...] == best_val[seg_ion]
            # last matching segment wins deterministically
            seg_best[seg_ion[match]] = np.nonzero(match)[0]
            for i in np.nonzero(none)[0]:
                si = seg_best[i]
                gm_i = np.asarray(gm[si])
                hh, oo = _parabola(fb[si, 1], fb[si, 0], fb[si, 2], gm_i)
                sel_h[i, 0] = float(hh)
                sel_mz[i, 0] = seg_lo[si] + self.step * float(oo)
                n_valid[i] = 1
        # m/z-ascending among the selected peaks (pad slots sort to the end)
        sort_mz = np.where(sel_h > -np.inf, sel_mz, np.inf)
        mz_order = np.argsort(sort_mz, axis=1, kind="stable")
        sel_h = sel_h[rix, mz_order]
        sel_mz = sel_mz[rix, mz_order]
        out = []
        for i in range(n_ions):
            n = int(n_valid[i])
            hi = sel_h[i, :n]
            out.append((sel_mz[i, :n].copy(), 100.0 * hi / hi.max()))
        return out
