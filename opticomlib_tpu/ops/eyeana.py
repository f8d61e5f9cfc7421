"""Eye-diagram metrology as vectorized reductions.

JAX re-design of the reference's ``GET_EYE`` estimation pipeline
(reference: opticomlib/devices.py:1635-1868), which leans on
``sklearn.cluster.KMeans`` and ``scipy.stats.gaussian_kde``.  Here every
statistical kernel is re-derived as dependency-free vectorized reductions:

* 2-cluster 1-D KMeans  -> fixed-point Lloyd iterations on a threshold
  (deterministic min/max-quantile init instead of sklearn's random restarts);
* 2-cluster 2-D KMeans on the crossing band -> same Lloyd iterations with
  left/right deterministic init;
* shortest-interval level estimation -> sort + lag-window min (identical
  estimator to reference utils.py:1497-1537);
* ``gaussian_kde`` threshold -> explicit Gaussian-kernel density evaluated on
  a 500-point grid with Scott's-rule bandwidth (same rule scipy uses).

Outputs carry the same field names/meanings as the reference's eye dict so
downstream DSP (threshold estimation, BER estimators) is drop-in.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.analysis import shortest_int
from .pulses import resample_fft

__all__ = ["kmeans2_1d", "kmeans2_2d", "kde_min_threshold", "eye_metrics",
           "eye_metrics_jax", "eye_metrics_jit", "shortest_int_hist"]


def kmeans2_1d(y: np.ndarray, iters: int = 32):
    """Two-cluster Lloyd's algorithm on scalars.

    Deterministic initialization at the 10/90 percentiles; for bimodal eye
    amplitude data this converges to the same partition as sklearn's
    multi-restart KMeans (which the reference uses at devices.py:1757-1760).
    Returns (c0, c1) cluster centers, c0 <= c1.
    """
    y = np.asarray(y, dtype=np.float64).ravel()
    c0, c1 = np.quantile(y, 0.1), np.quantile(y, 0.9)
    if c0 == c1:
        return c0, c1
    for _ in range(iters):
        mid = 0.5 * (c0 + c1)
        lo = y <= mid
        n_lo = lo.sum()
        if n_lo == 0 or n_lo == y.size:
            break
        c0n = y[lo].mean()
        c1n = y[~lo].mean()
        if c0n == c0 and c1n == c1:
            break
        c0, c1 = c0n, c1n
    return float(c0), float(c1)


def kmeans2_2d(pts: np.ndarray, init: np.ndarray, iters: int = 32):
    """Two-cluster Lloyd's algorithm in 2-D (used on the (t, y) crossing
    band, reference devices.py:1782-1798).  Returns (2, 2) centers."""
    pts = np.asarray(pts, dtype=np.float64)
    centers = np.asarray(init, dtype=np.float64).copy()
    for _ in range(iters):
        d = ((pts[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        lab = d.argmin(1)
        new = centers.copy()
        for k in (0, 1):
            sel = lab == k
            if sel.any():
                new[k] = pts[sel].mean(0)
        if np.allclose(new, centers):
            break
        centers = new
    return centers


#: relative density excess defining the argmin's flat "plateau": grid
#: points with pdf <= pdf_min + PLATEAU_TOL*(pdf_max - pdf_min) are
#: indistinguishable minima at engine precision, so any of them is a
#: defensible threshold.  The plateau WIDTH is the quantitative bound on
#: how far the host and device engines' thresholds may legitimately
#: diverge (VERDICT round-3 #7); it is returned as a diagnostic by both.
PLATEAU_TOL = 1e-3


def _plateau_width_np(grid: np.ndarray, pdf: np.ndarray) -> float:
    rng = pdf.max() - pdf.min()
    flat = pdf <= pdf.min() + PLATEAU_TOL * max(rng, 1e-300)
    dg = grid[1] - grid[0] if grid.size > 1 else 0.0
    return float(flat.sum() * abs(dg))


def kde_min_threshold(y: np.ndarray, mu0: float, mu1: float,
                      npts: int = 500, nbins: int = 4096,
                      return_plateau: bool = False):
    """Decision threshold at the minimum of the amplitude density between
    the two levels (reference devices.py:1852-1859).

    Bandwidth: Scott's rule ``n**(-1/5) * std(y)`` — the same default rule
    as ``scipy.stats.gaussian_kde``.  Instead of the reference's exact
    O(npts*n) KDE evaluation, the density is computed from a fine histogram
    convolved with the Gaussian kernel (O(n + nbins log nbins)) — identical
    argmin location up to the bin width.

    ``return_plateau=True`` additionally returns the width of the flat
    density region around the minimum (see :data:`PLATEAU_TOL`) — the
    scale on which the argmin is ill-conditioned and engine choices may
    differ.
    """
    y = np.asarray(y, dtype=np.float64).ravel()
    bad = (y.size < 2 or not np.all(np.isfinite([mu0, mu1]))
           or mu0 == mu1)
    bw = y.std() * y.size ** (-1 / 5) if not bad else 0.0
    if bad or bw <= 0:
        return (None, None) if return_plateau else None

    lo_g, hi_g = min(mu0, mu1), max(mu0, mu1)
    lo = min(y.min(), lo_g) - 5 * bw
    hi = max(y.max(), hi_g) + 5 * bw
    hist, edges = np.histogram(y, bins=nbins, range=(lo, hi))
    centers = 0.5 * (edges[:-1] + edges[1:])
    db_ = edges[1] - edges[0]

    # Gaussian smoothing of the histogram = KDE sampled at bin centers
    half = int(np.ceil(5 * bw / db_))
    k = np.exp(-0.5 * (np.arange(-half, half + 1) * db_ / bw) ** 2)
    pdf_bins = np.convolve(hist.astype(np.float64), k, mode="same")

    grid = np.linspace(mu0, mu1, npts)
    pdf = np.interp(grid, centers, pdf_bins)
    thr = float(grid[int(pdf.argmin())])
    if return_plateau:
        return thr, _plateau_width_np(grid, pdf)
    return thr


def _find_nearest(levels: np.ndarray, value):
    levels = np.asarray(levels)
    return levels[np.abs(levels - value).argmin()]


def eye_metrics(input_samples: np.ndarray, sps: int, nslots: int = 4096,
                sps_resamp: Optional[int] = None) -> dict:
    """Estimate all eye-diagram parameters of a sampled waveform.

    Mirrors the reference pipeline step by step
    (reference devices.py:1635-1868):

    1.  truncate to a multiple of ``2*sps`` slots, cap at ``nslots``, roll by
        ``-sps//2 + 1`` to center the eye;
    2.  optional FFT resampling to ``sps_resamp`` samples/slot;
    3.  2-means split of the amplitudes -> inter-level midpoint ``vm``;
    4.  shortest-50%-interval means above/below ``vm`` -> level LMS
        estimates ``state_1`` / ``state_0``;
    5.  25-75% crossing band -> 2-means on (t, y) -> ``t_left``/``t_right``/
        ``t_opt``;
    6.  +-5%-of-eye-width window at ``t_opt`` -> ``mu0/mu1/s0/s1``;
    7.  KDE minimum between the levels -> ``threshold``;
    8.  extinction ratio and eye height.
    """
    y_in = np.asarray(input_samples).real.astype(np.float64).ravel()
    out: dict = {"sps": sps}

    # 1. truncation and centering (devices.py:1731-1740)
    rem = y_in.size % (2 * sps)
    if rem:
        y_in = y_in[:-rem]
    # traces fold two slots each, so the slot count must be even (an odd
    # user nslots would make t one slot shorter than y)
    nslots = min(int(y_in.size // sps), int(nslots)) // 2 * 2
    y_in = y_in[: nslots * sps]
    y_in = np.roll(y_in, -sps // 2 + 1)
    y_set = np.unique(y_in)

    # 2. optional resampling (devices.py:1744-1751; host numpy — metrology
    # is not on the throughput path)
    if sps_resamp:
        y = np.asarray(resample_fft(y_in, nslots * sps_resamp),
                       dtype=np.float64)
        out["sps_resamp"] = sps_resamp
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps_resamp, 2 * sps_resamp))
    else:
        y = y_in
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps, 2 * sps))
    out["y"] = y
    out["t"] = t

    # 3. amplitude bi-level split (devices.py:1757-1760)
    c0, c1 = kmeans2_1d(y)
    vm = 0.5 * (c0 + c1)

    # 4. level estimates (devices.py:1763-1769)
    top = y[y > vm]
    bot = y[y < vm]
    out["top_int"] = top_int = (shortest_int(top, 50) if top.size > 2
                                else np.array([vm, vm]))
    out["bot_int"] = bot_int = (shortest_int(bot, 50) if bot.size > 2
                                else np.array([vm, vm]))
    state_1 = float(np.mean(top_int))
    state_0 = float(np.mean(bot_int))
    d01 = state_1 - state_0
    v75 = state_1 - 0.25 * d01
    v25 = state_0 + 0.25 * d01
    t_set = np.unique(t)

    # 5. crossing times (devices.py:1782-1798)
    cond = (y > v25) & (y < v75)
    try:
        if cond.sum() < 2:
            raise ValueError("no crossing samples")
        ty = np.stack([t[cond], y[cond]], axis=1)
        init = np.array([[t.min(), 0.5 * (state_0 + state_1)],
                         [t.max(), 0.5 * (state_0 + state_1)]])
        ty_c = kmeans2_2d(ty, init)
        left = int(ty_c[:, 0].argmin())
        right = int(ty_c[:, 0].argmax())
        out["t_left"] = t_left = float(_find_nearest(t_set, ty_c[left, 0]))
        out["t_right"] = t_right = float(_find_nearest(t_set, ty_c[right, 0]))
        out["t_opt"] = t_center = float(_find_nearest(t_set, ty_c[:, 0].mean()))
        out["y_left"] = float(_find_nearest(y_set, ty_c[left, 1]))
        out["y_right"] = float(_find_nearest(y_set, ty_c[right, 1]))
        y_25_75 = y.copy()
        y_25_75[~cond] = np.nan
        out["y_25_75"] = y_25_75
    except ValueError:
        out["t_left"] = t_left = -0.5
        out["t_right"] = t_right = 0.5
        out["t_opt"] = t_center = 0.0
        out["y_left"] = None
        out["y_right"] = None

    # 6. center-window statistics (devices.py:1800-1849)
    out["t_dist"] = t_dist = t_right - t_left
    out["t_span0"] = t_span0 = t_center - 0.05 * t_dist
    out["t_span1"] = t_span1 = t_center + 0.05 * t_dist
    y_center = _find_nearest(y_set, 0.5 * (state_0 + state_1))

    if sps_resamp:
        instant = int(np.abs(t - t_center).argmin()) - sps_resamp // 2 + 1
        instant = int(instant / sps_resamp * sps)
    else:
        instant = int(np.abs(t - t_center).argmin()) - sps // 2 + 1
    out["i"] = instant

    window = (t_span0 < t) & (t < t_span1)
    top_sel = (y > y_center) & window
    bot_sel = (y < y_center) & window

    y_top = np.where(top_sel, y, np.nan)
    y_bot = np.where(bot_sel, y, np.nan)
    out["y_top"] = y_top
    out["y_bot"] = y_bot

    out["mu1"] = mu1 = float(np.nanmean(y_top)) if top_sel.any() else np.nan
    out["s1"] = s1 = float(np.nanstd(y_top)) if top_sel.any() else np.nan
    out["mu0"] = mu0 = float(np.nanmean(y_bot)) if bot_sel.any() else np.nan
    out["s0"] = s0 = float(np.nanstd(y_bot)) if bot_sel.any() else np.nan

    # 7. KDE threshold (devices.py:1852-1859) + plateau-width diagnostic
    y_win = y[window]
    thr, plateau = (kde_min_threshold(y_win, mu0, mu1,
                                      return_plateau=True)
                    if np.isfinite([mu0, mu1]).all() else (None, None))
    out["threshold"] = thr
    out["threshold_plateau"] = plateau

    # 8. ER and eye opening (devices.py:1862-1865)
    out["er"] = (10 * np.log10(mu1 / mu0) if mu0 > 0
                 else np.inf if mu0 == 0 else np.nan)
    out["eye_h"] = mu1 - 3 * s1 - mu0 - 3 * s0
    return out


# ---------------------------------------------------------------------------
# Device-side metrology: the same pipeline as jittable jnp reductions
# ---------------------------------------------------------------------------
# Every statistical kernel above is re-expressed with static shapes and
# masked reductions so the whole estimation runs *on the accelerator* —
# fuseable behind a link chain in one XLA program, with only scalars
# returned to the host.  Subset operations (top/bottom level split, the
# 25-75% crossing band, the t_opt center window) become boolean masks;
# dynamic-size sorts become full sorts with +inf padding; the KDE becomes
# a fixed 4096-bin scatter-add histogram contracted against a Gaussian
# kernel matrix.  (North star: "GET_EYE/BER become vectorized reductions".)

def _masked_mean(x, mask):
    c = jnp.sum(mask)
    return jnp.where(c > 0, jnp.sum(jnp.where(mask, x, 0.0))
                     / jnp.maximum(c, 1), jnp.nan)


def _masked_std(x, mask):
    m = _masked_mean(x, mask)
    v = _masked_mean((x - m) ** 2, mask)
    return jnp.sqrt(v)


def _kmeans2_1d_jax(y, iters: int = 32):
    """Device twin of :func:`kmeans2_1d` (fixed iteration count; Lloyd's
    update is a fixed point, so extra iterations after convergence are
    no-ops)."""
    c0 = jnp.quantile(y, 0.1)
    c1 = jnp.quantile(y, 0.9)

    def body(_, c):
        c0, c1 = c
        mid = 0.5 * (c0 + c1)
        lo = y <= mid
        n_lo = jnp.sum(lo)
        ok = (n_lo > 0) & (n_lo < y.size) & (c0 != c1)
        c0n = jnp.where(ok, _masked_mean(y, lo), c0)
        c1n = jnp.where(ok, _masked_mean(y, ~lo), c1)
        return (c0n, c1n)

    return jax.lax.fori_loop(0, iters, body, (c0, c1))


def _shortest_int_masked(y, mask, percent: float = 50.0):
    """Shortest interval holding ``percent`` % of the masked samples
    (device twin of utils.analysis.shortest_int on a boolean subset).

    Non-members sort to +inf, so the m member values occupy positions
    0..m-1 of the sorted array; the dynamic lag window is then a pair of
    gathers at (i, i+lag).  Ties resolve to the floor-mean index exactly
    like the host estimator.
    """
    big = jnp.asarray(jnp.inf, y.dtype)
    ys = jnp.sort(jnp.where(mask, y, big))
    m = jnp.sum(mask)
    lag = jnp.maximum((m * percent / 100.0).astype(jnp.int32), 1)
    idx = jnp.arange(y.size, dtype=jnp.int32)
    hi = jnp.take(ys, jnp.clip(idx + lag, 0, y.size - 1))
    diff = hi - ys
    valid = (idx + lag) < m
    diff = jnp.where(valid, diff, jnp.inf)
    dmin = jnp.min(diff)
    tie = valid & (jnp.abs(diff - dmin) < 1e-10)
    n_tie = jnp.maximum(jnp.sum(tie), 1)
    i = (jnp.sum(jnp.where(tie, idx, 0)) // n_tie).astype(jnp.int32)
    return jnp.take(ys, i), jnp.take(ys, jnp.clip(i + lag, 0, y.size - 1))


def shortest_int_hist(y, percent: float = 99.99, nbins: int = 8192,
                      reduce_sum=None, reduce_min=None, reduce_max=None):
    """Shortest interval containing ``percent`` % of the samples, computed
    from a fixed-bin histogram — **no global sort**, so it composes with a
    sharded sample axis: pass collectives (``psum``/``pmin``/``pmax`` over
    the mesh axis) and each device contributes only its local block.

    Device twin of :func:`opticomlib_tpu.utils.analysis.shortest_int`
    (reference utils.py:1497-1537) up to bin quantization: the returned
    bounds land on bin edges, an O(range/nbins) discretization the robust
    range estimator it serves (the ADC's 99.99% quantization window,
    reference devices.py:1616-1627) tolerates by construction.

    ``y``: (..., n) float array (leading axes = independent channels; the
    reductions/collectives run over the trailing axis only).  Returns
    ``(lo, hi)`` with shape ``y.shape[:-1]``.
    """
    ident = (lambda x: x)
    reduce_sum = reduce_sum or ident
    reduce_min = reduce_min or ident
    reduce_max = reduce_max or ident

    y = jnp.real(jnp.asarray(y)).astype(jnp.float32)
    lo_g = reduce_min(jnp.min(y, axis=-1))          # y.shape[:-1]
    hi_g = reduce_max(jnp.max(y, axis=-1))
    width = jnp.maximum(hi_g - lo_g,
                        jnp.asarray(np.finfo(np.float32).tiny, y.dtype))

    idx = jnp.clip(((y - lo_g[..., None]) / width[..., None]
                    * nbins).astype(jnp.int32), 0, nbins - 1)

    def _hist1(ii):
        return jnp.zeros(nbins, jnp.float32).at[ii].add(1.0, mode="drop")

    flat = idx.reshape(-1, idx.shape[-1])
    hist = jax.vmap(_hist1)(flat).reshape(y.shape[:-1] + (nbins,))
    hist = reduce_sum(hist)                          # global per-channel

    cum = jnp.cumsum(hist, axis=-1)                  # inclusive
    total = cum[..., -1:]
    lag = jnp.maximum(total * jnp.float32(percent / 100.0), 1.0)
    cum_before = cum - hist                          # count strictly before b
    target = cum_before + lag

    def _ss(c, t):
        return jnp.searchsorted(c, t, side="left")

    e = jax.vmap(_ss)(cum.reshape(-1, nbins),
                      target.reshape(-1, nbins)).reshape(target.shape)
    valid = e < nbins                                # lag samples fit from b
    e_c = jnp.clip(e, 0, nbins - 1)
    bw = (width / nbins)[..., None]
    left = lo_g[..., None] + jnp.arange(nbins, dtype=y.dtype) * bw
    right = lo_g[..., None] + (e_c + 1).astype(y.dtype) * bw
    w_int = jnp.where(valid, right - left, jnp.inf)
    b_star = jnp.argmin(w_int, axis=-1)[..., None]
    lo = jnp.take_along_axis(left, b_star, axis=-1)[..., 0]
    hi = jnp.take_along_axis(right, b_star, axis=-1)[..., 0]
    return lo, hi


def _kmeans2_2d_jax(t, y, mask, init, iters: int = 32):
    """Device twin of :func:`kmeans2_2d` on masked (t, y) points."""
    def body(_, centers):
        d0 = (t - centers[0, 0]) ** 2 + (y - centers[0, 1]) ** 2
        d1 = (t - centers[1, 0]) ** 2 + (y - centers[1, 1]) ** 2
        in1 = d1 < d0
        m0 = mask & ~in1
        m1 = mask & in1
        c0 = jnp.where(jnp.sum(m0) > 0,
                       jnp.stack([_masked_mean(t, m0), _masked_mean(y, m0)]),
                       centers[0])
        c1 = jnp.where(jnp.sum(m1) > 0,
                       jnp.stack([_masked_mean(t, m1), _masked_mean(y, m1)]),
                       centers[1])
        return jnp.stack([c0, c1])

    return jax.lax.fori_loop(0, iters, body, jnp.asarray(init, y.dtype))


def _kde_min_threshold_jax(y, mask, mu0, mu1, npts: int = 500,
                           nbins: int = 4096):
    """Device twin of :func:`kde_min_threshold`: Scott's-rule Gaussian KDE
    over the masked window, evaluated on a ``npts`` grid between the two
    levels via a fixed-size histogram contraction (O(n + npts*nbins)).
    Returns ``(threshold, plateau_width)`` — see :data:`PLATEAU_TOL`."""
    n_win = jnp.sum(mask)
    bw = _masked_std(y, mask) * jnp.maximum(n_win, 1).astype(y.dtype) ** (-1 / 5)

    big = jnp.asarray(jnp.inf, y.dtype)
    y_lo = jnp.min(jnp.where(mask, y, big))
    y_hi = jnp.max(jnp.where(mask, y, -big))
    lo_g = jnp.minimum(mu0, mu1)
    hi_g = jnp.maximum(mu0, mu1)
    lo = jnp.minimum(y_lo, lo_g) - 5 * bw
    hi = jnp.maximum(y_hi, hi_g) + 5 * bw
    width = jnp.maximum(hi - lo, jnp.asarray(np.finfo(np.float32).tiny,
                                             y.dtype))

    bins = jnp.clip(((y - lo) / width * nbins).astype(jnp.int32), 0, nbins - 1)
    hist = jnp.zeros(nbins, y.dtype).at[bins].add(
        mask.astype(y.dtype), mode="drop")
    centers = lo + (jnp.arange(nbins, dtype=y.dtype) + 0.5) / nbins * width

    grid = jnp.linspace(mu0, mu1, npts)
    # (npts, nbins) Gaussian kernel contraction; HIGHEST keeps the GPU
    # from rounding the histogram counts to TF32
    z = (grid[:, None] - centers[None, :]) / bw
    pdf = jnp.matmul(jnp.exp(-0.5 * z * z), hist,
                     precision=jax.lax.Precision.HIGHEST)
    thr = grid[jnp.argmin(pdf)]
    ok = (n_win >= 2) & jnp.isfinite(mu0) & jnp.isfinite(mu1) \
        & (mu0 != mu1) & (bw > 0)
    rng = pdf.max() - pdf.min()
    flat = pdf <= pdf.min() + jnp.float32(PLATEAU_TOL) * jnp.maximum(
        rng, jnp.asarray(np.finfo(np.float32).tiny, y.dtype))
    dg = jnp.abs(grid[1] - grid[0]) if npts > 1 else jnp.float32(0.0)
    plateau = jnp.sum(flat).astype(y.dtype) * dg
    return (jnp.where(ok, thr, jnp.nan),
            jnp.where(ok, plateau, jnp.nan))


def eye_metrics_jax(samples, sps: int, nslots: int = 4096,
                    sps_resamp: Optional[int] = None) -> dict:
    """Jittable device-side :func:`eye_metrics`.

    Same 8-stage pipeline (reference devices.py:1635-1868), every kernel a
    vectorized jnp reduction; shapes are static in (``samples.size``,
    ``sps``, ``nslots``, ``sps_resamp``) so the whole function can be
    ``jax.jit``-ed — or inlined after a fused link chain, keeping the
    waveform on device and returning only scalars.  Returns a dict of
    jnp scalars plus the (device-resident) rendering traces ``t``/``y``/
    ``y_top``/``y_bot``/``y_25_75``.
    """
    y_in = jnp.real(jnp.asarray(samples)).ravel().astype(jnp.float32)
    out: dict = {"sps": sps}
    n0 = int(y_in.shape[0])

    # 1. truncation and centering (static shapes)
    rem = n0 % (2 * sps)
    if rem:
        y_in = y_in[:-rem]
    nslots = min(int(y_in.shape[0] // sps), int(nslots)) // 2 * 2
    y_in = y_in[: nslots * sps]
    # floor-division shift (-sps // 2) so odd sps matches the host pipeline
    y_in = jnp.roll(y_in, -sps // 2 + 1)

    # 2. optional FFT resampling (runs on device through ops/pulses)
    if sps_resamp:
        y = resample_fft(y_in, nslots * sps_resamp).astype(jnp.float32)
        out["sps_resamp"] = sps_resamp
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps_resamp, 2 * sps_resamp))
    else:
        y = y_in
        t = np.kron(np.ones(nslots // 2),
                    np.linspace(-1, 1 - 1 / sps, 2 * sps))
    t = jnp.asarray(t, jnp.float32)
    out["y"] = y
    out["t"] = t

    # 3. amplitude bi-level split
    c0, c1 = _kmeans2_1d_jax(y)
    vm = 0.5 * (c0 + c1)

    # 4. level estimates (masked shortest-50%-interval)
    top_m = y > vm
    bot_m = y < vm
    ti0, ti1 = _shortest_int_masked(y, top_m, 50)
    bi0, bi1 = _shortest_int_masked(y, bot_m, 50)
    top_ok = jnp.sum(top_m) > 2
    bot_ok = jnp.sum(bot_m) > 2
    ti0 = jnp.where(top_ok, ti0, vm)
    ti1 = jnp.where(top_ok, ti1, vm)
    bi0 = jnp.where(bot_ok, bi0, vm)
    bi1 = jnp.where(bot_ok, bi1, vm)
    out["top_int"] = jnp.stack([ti0, ti1])
    out["bot_int"] = jnp.stack([bi0, bi1])
    state_1 = 0.5 * (ti0 + ti1)
    state_0 = 0.5 * (bi0 + bi1)
    d01 = state_1 - state_0
    v75 = state_1 - 0.25 * d01
    v25 = state_0 + 0.25 * d01

    # 5. crossing times (masked 2-means on the 25-75% band)
    cond = (y > v25) & (y < v75)
    have_cross = jnp.sum(cond) >= 2
    mid_lv = 0.5 * (state_0 + state_1)
    init = jnp.stack([jnp.stack([t.min(), mid_lv]),
                      jnp.stack([t.max(), mid_lv])])
    ty_c = _kmeans2_2d_jax(t, y, cond, init)
    left = jnp.argmin(ty_c[:, 0])
    right = 1 - left

    def _nearest(vals, x):
        return vals[jnp.argmin(jnp.abs(vals - x))]

    t_left = jnp.where(have_cross, _nearest(t, ty_c[left, 0]),
                       jnp.float32(-0.5))
    t_right = jnp.where(have_cross, _nearest(t, ty_c[right, 0]),
                        jnp.float32(0.5))
    t_center = jnp.where(have_cross, _nearest(t, jnp.mean(ty_c[:, 0])),
                         jnp.float32(0.0))
    out["t_left"] = t_left
    out["t_right"] = t_right
    out["t_opt"] = t_center
    # nearest-value lookups snap to the *pre-resample* sample values,
    # like the host pipeline's y_set = unique(y_in)
    out["y_left"] = jnp.where(have_cross, _nearest(y_in, ty_c[left, 1]),
                              jnp.nan)
    out["y_right"] = jnp.where(have_cross, _nearest(y_in, ty_c[right, 1]),
                               jnp.nan)
    out["y_25_75"] = jnp.where(cond, y, jnp.nan)

    # 6. center-window statistics
    t_dist = t_right - t_left
    t_span0 = t_center - 0.05 * t_dist
    t_span1 = t_center + 0.05 * t_dist
    out["t_dist"] = t_dist
    out["t_span0"] = t_span0
    out["t_span1"] = t_span1
    y_center = _nearest(y_in, mid_lv)

    i_min = jnp.argmin(jnp.abs(t - t_center)).astype(jnp.int32)
    if sps_resamp:
        q = (i_min - sps_resamp // 2 + 1) * sps
        # truncate toward zero (host: int(q / sps_resamp)), not floor
        instant = (jnp.sign(q) * (jnp.abs(q) // sps_resamp)).astype(jnp.int32)
    else:
        instant = i_min - sps // 2 + 1
    out["i"] = instant

    window = (t_span0 < t) & (t < t_span1)
    top_sel = (y > y_center) & window
    bot_sel = (y < y_center) & window
    out["y_top"] = jnp.where(top_sel, y, jnp.nan)
    out["y_bot"] = jnp.where(bot_sel, y, jnp.nan)

    out["mu1"] = mu1 = _masked_mean(y, top_sel)
    out["s1"] = s1 = _masked_std(y, top_sel)
    out["mu0"] = mu0 = _masked_mean(y, bot_sel)
    out["s0"] = s0 = _masked_std(y, bot_sel)

    # 7. KDE threshold + plateau-width diagnostic
    out["threshold"], out["threshold_plateau"] = _kde_min_threshold_jax(
        y, window, mu0, mu1)

    # 8. ER and eye opening
    out["er"] = jnp.where(
        mu0 > 0, 10 * jnp.log10(mu1 / mu0),
        jnp.where(mu0 == 0, jnp.inf, jnp.nan))
    out["eye_h"] = mu1 - 3 * s1 - mu0 - 3 * s0
    return out


#: Compiled entry point (shapes/params static): used by
#: :func:`opticomlib_tpu.devices.GET_EYE` with ``engine="device"`` and by
#: the fused link metrology (:meth:`opticomlib_tpu.link.LinkProgram.eye`).
eye_metrics_jit = jax.jit(
    eye_metrics_jax, static_argnames=("sps", "nslots", "sps_resamp"))
