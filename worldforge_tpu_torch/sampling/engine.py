"""The WorldForge denoise engines: UniPC (Wan) and flow-match Euler
(LongCat), each with IRR, DSG and the guided fuse.

Counterpart of ``worldforge_tpu/sampling/engine.py``:

- ``wan_denoise_loop`` / ``longcat_denoise_loop``: the host-loop engines,
  one Python step at a time with host-side FLF selection.
- ``wan_denoise_scan`` / ``longcat_denoise_scan``: the whole-loop runners.
  The per-step scalars are device tables (``_wan_tables`` /
  ``_longcat_tables``), the step body (``make_wan_body`` /
  ``make_longcat_body``) keeps the loop's state machine with FLF selected
  on the device, and the plan (``wan_scan_chunks`` / ``longcat_scan_chunks``)
  cuts the segments into chunks. On the card each segment kind's body is
  captured once as a CUDA graph and replayed
  (``runtime/step_graph.py``); on the CPU it runs as a Python loop over the
  tables.
- ``auto_exec_chunk``: the chunk plan sized from step and fuse costs. The
  card has no execution watchdog, so by default the plan is one chunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from worldforge_tpu_torch.sampling.flow_match import (fm_add_noise,
                                                      fm_euler_step,
                                                      fm_pred_x0)
from worldforge_tpu_torch.sampling.guidance import GuidanceConfig
from worldforge_tpu_torch.sampling.unipc import (FlowUniPCSchedule, add_noise,
                                                 dsg_extrapolate,
                                                 flow_pred_x0, unip_update)


def wan_denoise_loop(
    model_fn: Callable[[torch.Tensor, float, int, int], torch.Tensor],
    latents: torch.Tensor,
    sched: FlowUniPCSchedule,
    guidance: GuidanceConfig,
    *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    fuse_fn: Optional[Callable] = None,
    callback: Optional[Callable] = None,
    record_r0: bool = True,
) -> torch.Tensor:
    """Run the full denoise loop.

    model_fn(latents, t_model, i, r) -> velocity (CFG already applied).
    fuse_fn(x0, i, r) -> fused x0 (guided pixel fusion, FLF at r = 0);
    None = off.
    noise_fn(shape) -> IRR re-noise override (array-like); otherwise the
    noise is drawn from ``generator`` on the latents' device.
    record_r0: whether the r=0 prediction joins the DSG history (the
    reference records it only under CFG).
    """
    m0 = m1 = None
    guided_on = fuse_fn is not None

    for i in range(sched.num_steps):
        order = sched.order_for_step(i, min(i, 2))
        t_main = float(sched.timesteps[i])
        t_res = float(sched.resample_timesteps[i])

        deriv_history: List[torch.Tensor] = []
        prev_sample = None
        n_resample = (guidance.resample_steps
                      if i < guidance.resample_round else 1)

        for r in range(n_resample):
            t_model = t_main if r == 0 else t_res
            v = model_fn(latents, t_model, i, r)
            if r > 0 or record_r0:
                deriv_history.append(v)

            x0 = flow_pred_x0(sched, i, v, latents)
            if guided_on and i < guidance.guide_steps:
                x0 = fuse_fn(x0, i, r)

            if r == 0:
                m1 = m0
            m0 = x0
            # in resample mode the next-sigma index clamps to the resample
            # table, so at the FINAL step the update is the identity
            is_final = i == sched.num_steps - 1
            if r > 0 and is_final:
                prev_sample = latents
            else:
                prev_sample = unip_update(sched, i, order, latents, m0,
                                          m1 if order >= 2 else None)

            if i < guidance.resample_round and r < n_resample - 1:
                noise = _draw_noise(x0.shape, x0, generator, noise_fn)
                latents = add_noise(sched, i, x0, noise)

        if len(deriv_history) > 1:
            omega = (guidance.omega if i < guidance.guide_steps
                     else guidance.omega_resample)
            better = dsg_extrapolate(deriv_history[-1], deriv_history[0],
                                     omega)
            m0 = flow_pred_x0(sched, i, better, latents)
            if not (n_resample > 1 and i == sched.num_steps - 1):
                latents = unip_update(sched, i, order, latents, m0,
                                      m1 if order >= 2 else None)
        else:
            latents = prev_sample

        if callback is not None:
            callback(i, latents)
    return latents


def _draw_noise(shape, like: torch.Tensor, generator, noise_fn):
    if noise_fn is not None:
        return torch.as_tensor(noise_fn(tuple(shape)),
                               dtype=like.dtype).to(like.device)
    return torch.randn(shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def longcat_denoise_loop(
    model_fn: Callable,
    latents: torch.Tensor,
    sched,
    guidance: GuidanceConfig,
    *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    fuse_fn: Optional[Callable] = None,
    callback: Optional[Callable] = None,
) -> torch.Tensor:
    """LongCat i2v denoise loop: flow-match Euler with IRR and DSG on the
    noise frames, the cond latent in frame 0.

    model_fn(latents_full, t, i, r) -> the NEGATED velocity of the full
    latents (CFG-zero applied). fuse_fn(x0_full, i, r) -> fused full-latent
    x0; it runs only at r == 0 while i < guide_steps, on the full latents
    with a zeroed frame-0 velocity, and feeds the IRR re-noise (the fused x0
    at r = 0, the unfused one after). The Euler update integrates the raw
    velocity. The DSG history holds the sliced noise-frame velocity
    ``v[:, :, 1:]``. ``guided`` implies a reference: without a fuse_fn the
    call is one plain pass per step (no IRR, no DSG). The re-noise comes
    from ``noise_fn(shape)`` when given, else from ``generator`` on the
    latents' device. ``callback(i, latents)`` runs after each step."""
    guided_on = guidance.guided and fuse_fn is not None

    for i in range(sched.num_steps):
        t_val = float(sched.timesteps[i])
        deriv_history: List[torch.Tensor] = []
        prev_noise = None
        n_resample = (guidance.resample_steps
                      if (guided_on and i < guidance.resample_round) else 1)

        for r in range(n_resample):
            v = model_fn(latents, t_val, i, r)
            v_noise = v[:, :, 1:]
            deriv_history.append(v_noise)
            x_noise = latents[:, :, 1:]
            x0 = fm_pred_x0(sched, i, v_noise, x_noise)
            if guided_on and i < guidance.guide_steps and r == 0:
                v_full = torch.cat([torch.zeros_like(v[:, :, :1]), v_noise],
                                   dim=2)
                x0_full = fm_pred_x0(sched, i, v_full, latents)
                x0 = fuse_fn(x0_full, i, r)[:, :, 1:]

            prev_noise = fm_euler_step(sched, i, x_noise, v_noise)

            if i < guidance.resample_round and r < n_resample - 1:
                noise = _draw_noise(x0.shape, x0, generator, noise_fn)
                latents = torch.cat([latents[:, :, :1],
                                     fm_add_noise(sched, i, x0, noise)],
                                    dim=2)

        if (guided_on and i < guidance.resample_round
                and len(deriv_history) > 1):
            omega = (guidance.omega if i < guidance.guide_steps
                     else guidance.omega_resample)
            better = dsg_extrapolate(deriv_history[-1], deriv_history[0],
                                     omega)
            nxt = fm_euler_step(sched, i, latents[:, :, 1:], better)
        else:
            nxt = prev_noise
        latents = torch.cat([latents[:, :, :1], nxt], dim=2)
        if callback is not None:
            callback(i, latents)
    return latents


# ------------------------------------------------------------ scan tables


def _order_coeffs(sched: FlowUniPCSchedule):
    """Per-step UniP coefficients with the order schedule baked in
    (order_i = min(2, N-i, i+1)); cm1 is 0 where the order is 1, so the
    update is always cx*x + cm0*m0 + cm1*m1."""
    n = sched.num_steps
    cx = np.asarray(sched.c_x, np.float32)
    cm0 = np.empty(n, np.float32)
    cm1 = np.empty(n, np.float32)
    for i in range(n):
        if min(2, n - i, i + 1) >= 2:
            cm0[i] = sched.c_m0_o2[i]
            cm1[i] = sched.c_m1_o2[i]
        else:
            cm0[i] = sched.c_m0_o1[i]
            cm1[i] = 0.0
    return cx, cm0, cm1


def _wan_tables(sched: FlowUniPCSchedule, guidance: GuidanceConfig,
                fuse_on: bool):
    """Segment bounds and the per-step tables of the Wan runner, in the
    order (t, t_resample, c_x, c_m0, c_m1, sigma, omega, final, step), all
    float32. The order coefficients are baked per step, so any slice of the
    tables keeps the multistep semantics; m0 / m1 cross chunks in the
    carry."""
    n = sched.num_steps
    r_round = min(guidance.resample_round, n)
    g_steps = min(guidance.guide_steps, n)
    cx, cm0, cm1 = _order_coeffs(sched)
    ts = np.asarray(sched.timesteps, np.float32)
    trs = np.asarray(sched.resample_timesteps, np.float32)
    sig = np.asarray(sched.sigmas[:-1], np.float32)
    omegas = np.where(np.arange(n) < g_steps, guidance.omega,
                      guidance.omega_resample).astype(np.float32)
    finals = (np.arange(n) == n - 1).astype(np.float32)
    steps = np.arange(n, dtype=np.float32)
    bounds = sorted({0, g_steps if fuse_on else 0, r_round, n})
    segments = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    tables = (ts, trs, cx, cm0, cm1, sig, omegas, finals, steps)
    return segments, tables, g_steps, r_round


def _longcat_tables(sched, guidance: GuidanceConfig, fuse_on: bool):
    """Segment bounds and the per-step tables of the LongCat runner, in the
    order (t, sigma, sigma_next, omega, step)."""
    n = sched.num_steps
    r_round = min(guidance.resample_round, n)
    g_steps = min(guidance.guide_steps, n)
    ts = np.asarray(sched.timesteps, np.float32)
    sig = np.asarray(sched.sigmas[:-1], np.float32)
    sig_next = np.asarray(sched.sigmas[1:], np.float32)
    omegas = np.where(np.arange(n) < g_steps, guidance.omega,
                      guidance.omega_resample).astype(np.float32)
    steps = np.arange(n, dtype=np.float32)
    bounds = sorted({0, g_steps if fuse_on else 0,
                     r_round if guidance.guided else 0, n})
    segments = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    return segments, (ts, sig, sig_next, omegas, steps), g_steps, r_round


# ------------------------------------------------------- chunk plan sizing
#
# The chunk plan exists for runtimes that end any single execution after a
# time limit. The card has none, so ``watchdog_s`` defaults to infinity and
# ``auto_exec_chunk`` returns one chunk; a caller that serves under such a
# limit passes it. The cost tables are the card's own.

WATCHDOG_SECONDS = math.inf

# (tokens -> seconds per plain step): "wan" a CFG pair (2 Wan2.1-14B
# forwards), "longcat" a distilled step (1 LongCat-13.6B forward),
# "longcat-bsa" a refine step (BSA 0.875). Measured by chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md §5): the Wan forward 0.566 s at
# 7,800 tokens and 1.853 s at 20,280, the LongCat forward 1.840 s at
# 20,280 and the refine forward 4.729 s at 56,320.
STEP_COST_ANCHORS = {
    "wan": ((7800, 1.132), (20280, 3.706)),
    "longcat": ((20280, 1.840),),
    "longcat-bsa": ((56320, 4.729),),
}

# (pixels per frame -> seconds per VAE fuse round trip of a 49-frame clip):
# the LongCat guided step's fuse at 480x832, ~1.5 s (chip_smoke.py, NVIDIA
# H100 80GB HBM3 at 700 W, PERF.md §5).
FUSE_COST_ANCHORS = ((399360, 1.5),)


def _cost_exponent() -> float:
    """The exponent of the wan anchor pair (cost ~ tokens^e), used for the
    families with one anchor."""
    (x0, c0), (x1, c1) = sorted(STEP_COST_ANCHORS["wan"])[:2]
    return math.log(c1 / c0) / math.log(x1 / x0)


def _interp_cost(anchors, x: float) -> float:
    """Power-law (log-log) interpolation through the anchors; one anchor
    extrapolates with the wan pair's exponent."""
    if len(anchors) == 1:
        x0, c0 = anchors[0]
        return c0 * (x / x0) ** _cost_exponent()
    pts = sorted(anchors)
    for (x0, c0), (x1, c1) in zip(pts[:-1], pts[1:]):
        if x <= x1 or (x0, c0) == pts[-2]:
            return c0 * (x / x0) ** (math.log(c1 / c0) / math.log(x1 / x0))
    raise AssertionError  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class ExecChunkPlan:
    exec_chunk: int        # plain-step equivalents per chunk
    fuse_cost: float       # fuse / plain step cost ratio
    plain_step_s: float    # estimated seconds per plain step
    fuse_s: float          # estimated seconds per fuse round trip
    max_chunk_s: float     # estimated seconds of the longest chunk
    fits_watchdog: bool    # False: even one step is over the limit


def auto_exec_chunk(model: str, tokens: int, *, fuse_pixels: int = 0,
                    guidance: Optional[GuidanceConfig] = None,
                    watchdog_s: float = WATCHDOG_SECONDS,
                    safety: float = 0.8) -> ExecChunkPlan:
    """The chunk plan sized from the cost tables: ``tokens`` is the DiT's
    sequence length, ``fuse_pixels`` H*W of the pixel-space fuse (0: no
    fuse). Every estimated chunk stays under ``safety * watchdog_s``; with
    no limit (the default) the plan is one chunk."""
    plain = _interp_cost(STEP_COST_ANCHORS[model], float(tokens))
    fuse = (_interp_cost(FUSE_COST_ANCHORS, float(fuse_pixels))
            if fuse_pixels else 0.0)
    budget = safety * watchdog_s
    k = max(1, int(budget / plain)) if math.isfinite(budget) else 10 ** 9
    fuse_ratio = (fuse / plain) if fuse_pixels else 0.5
    g = guidance or GuidanceConfig()
    worst = k * plain
    if fuse_pixels and g.guided:
        for seg_fuse, seg_irr in ((True, True), (True, False),
                                  (False, True)):
            rs = g.resample_steps if seg_irr else 1
            weight = rs * (1.0 + (fuse_ratio if seg_fuse else 0.0))
            k_seg = max(1, int(k / weight))
            per_step = rs * (plain + (fuse if seg_fuse else 0.0))
            worst = max(worst, k_seg * per_step)
    return ExecChunkPlan(exec_chunk=k, fuse_cost=fuse_ratio,
                         plain_step_s=plain, fuse_s=fuse, max_chunk_s=worst,
                         fits_watchdog=worst <= watchdog_s)


def _seg_chunk_steps(exec_chunk: int, guidance: GuidanceConfig,
                     seg_fuse: bool, seg_irr: bool,
                     fuse_cost: float = 0.5) -> int:
    """Steps per chunk of one segment: ``exec_chunk`` counts plain steps,
    and an IRR step costs ``resample_steps`` model calls, plus as many
    fuses (``fuse_cost`` of a model call each) where it fuses."""
    rs = guidance.resample_steps if seg_irr else 1
    weight = rs * (1.0 + (fuse_cost if seg_fuse else 0.0))
    return max(1, int(exec_chunk / weight))


def _chunks(segments, tables, exec_chunk, guidance, fuse_cost, kind):
    plan = []
    for a, b in segments:
        seg_fuse, seg_irr = kind(a)
        k = _seg_chunk_steps(exec_chunk, guidance, seg_fuse, seg_irr,
                             fuse_cost=fuse_cost)
        for c in range(a, b, k):
            d = min(c + k, b)
            plan.append((seg_fuse, seg_irr, tuple(t[c:d] for t in tables)))
    return plan


def wan_scan_chunks(sched: FlowUniPCSchedule, guidance: GuidanceConfig,
                    fuse_on: bool, exec_chunk: int, fuse_cost: float = 0.5):
    """The Wan runner's plan: its segments cut into chunks of at most
    ``exec_chunk`` plain-step equivalents (``_seg_chunk_steps``). Returns
    [(seg_fuse, seg_irr, tables sliced to the chunk), ...]."""
    segments, tables, g_steps, r_round = _wan_tables(sched, guidance,
                                                     fuse_on)
    return _chunks(segments, tables, exec_chunk, guidance, fuse_cost,
                   lambda a: (fuse_on and a < g_steps, a < r_round))


def longcat_scan_chunks(sched, guidance: GuidanceConfig, fuse_on: bool,
                        exec_chunk: int, fuse_cost: float = 0.5):
    """The LongCat runner's plan, as ``wan_scan_chunks``."""
    segments, tables, g_steps, r_round = _longcat_tables(sched, guidance,
                                                         fuse_on)
    return _chunks(segments, tables, exec_chunk, guidance, fuse_cost,
                   lambda a: (fuse_on and a < g_steps,
                              guidance.guided and a < r_round))


# ------------------------------------------------------------ step bodies
#
# A body is ``body(carry, xs, draw) -> (carry, aux)``: ``carry`` a tuple of
# tensors, ``xs`` the step's row of the tables as 0-dim tensors on the
# carry's device, ``draw(shape, like)`` the IRR re-noise (drawn in the
# loop's order), ``aux`` the FLF mask [C] of the step (None without FLF).
# Every step-dependent number is a tensor, so one capture serves every step
# of its segment kind.


def make_wan_body(model_fn: Callable, fuse_fn: Optional[Callable],
                  flf_fn: Optional[Callable], guidance: GuidanceConfig,
                  record_r0: bool, seg_fuse: bool, seg_irr: bool):
    """The Wan UniPC + IRR / FLF / DSG step. Carry (latents, m0, m1); xs
    in the ``_wan_tables`` order. model_fn(lat, t) -> velocity (CFG
    inside); fuse_fn(x0, step) -> fused x0; flf_fn(pre, fused, step) ->
    (x0, mask). Same state machine as ``wan_denoise_loop``, the
    resample-mode final-step identity included; FLF runs at r = 0 only."""
    rs = guidance.resample_steps
    dsg_on = seg_irr and (rs >= 2 if record_r0 else rs >= 3)

    def body(carry, xs, draw):
        lat, m0, m1 = carry
        t_i, tr_i, cxi, c0i, c1i, s_i, om_i, fin_i, step_i = xs
        v0 = model_fn(lat, t_i)
        x0 = lat - s_i * v0
        mask = None
        if seg_fuse:
            fused = fuse_fn(x0, step_i)
            if flf_fn is not None:
                fused, mask = flf_fn(x0, fused, step_i)
            x0 = fused
        m1n, m0n = m0, x0
        prev = cxi * lat + c0i * m0n + c1i * m1n

        v_resample = []
        if seg_irr and rs >= 2:
            for _ in range(rs - 1):
                noise = draw(tuple(x0.shape), x0)
                lat = (1.0 - s_i) * x0 + s_i * noise
                v = model_fn(lat, tr_i)
                v_resample.append(v)
                x0 = lat - s_i * v
                if seg_fuse:
                    x0 = fuse_fn(x0, step_i)      # no FLF while resampling
                m0n = x0
                prev = torch.where(fin_i > 0, lat,
                                   cxi * lat + c0i * m0n + c1i * m1n)

        if dsg_on:
            worse = v0 if record_r0 else v_resample[0]
            better = dsg_extrapolate(v_resample[-1], worse, om_i)
            m0n = lat - s_i * better
            lat_next = torch.where(fin_i > 0, lat,
                                   cxi * lat + c0i * m0n + c1i * m1n)
        else:
            lat_next = prev
        return (lat_next, m0n, m1n), mask

    return body


def make_longcat_body(model_fn: Callable, fuse_fn: Optional[Callable],
                      guidance: GuidanceConfig, seg_fuse: bool,
                      seg_irr: bool):
    """The LongCat flow-match Euler + IRR / DSG step on the noise frames,
    the cond latent in frame 0. Carry (latents,); xs in the
    ``_longcat_tables`` order. model_fn(lat_full, t) -> the NEGATED
    velocity; fuse_fn(x0_full, step) -> fused full-latent x0 (FLF inside),
    run at r = 0 only. Same state machine as ``longcat_denoise_loop``."""
    rs = guidance.resample_steps
    dsg_on = seg_irr and rs >= 2 and guidance.guided

    def run_r(lat, t_i, s_i, sn_i, step_i, first):
        v = model_fn(lat, t_i)
        vn = v[:, :, 1:]
        x0 = lat[:, :, 1:] - s_i * vn
        if seg_fuse and first:
            vfull = torch.cat([torch.zeros_like(v[:, :, :1]), vn], dim=2)
            x0 = fuse_fn(lat - s_i * vfull, step_i)[:, :, 1:]
        prev = lat[:, :, 1:] + (sn_i - s_i) * vn
        return vn, x0, prev

    def body(carry, xs, draw):
        (lat,) = carry
        t_i, s_i, sn_i, om_i, step_i = xs
        v0, x0, prev = run_r(lat, t_i, s_i, sn_i, step_i, True)
        v_last = v0
        if seg_irr and rs >= 2:
            for _ in range(rs - 1):
                noise = draw(tuple(x0.shape), x0)
                lat = torch.cat([lat[:, :, :1],
                                 (1.0 - s_i) * x0 + s_i * noise], dim=2)
                v_last, x0, prev = run_r(lat, t_i, s_i, sn_i, step_i, False)
        if dsg_on:
            better = dsg_extrapolate(v_last, v0, om_i)
            nxt = lat[:, :, 1:] + (sn_i - s_i) * better
        else:
            nxt = prev
        return (torch.cat([lat[:, :, :1], nxt], dim=2),), None

    return body


# --------------------------------------------------------------- runners


def _loop_draw(generator, noise_fn):
    """The re-noise of the eager runner: ``noise_fn`` when given, else
    ``generator`` on the latents' device."""
    return lambda shape, like: _draw_noise(shape, like, generator, noise_fn)


def run_plan_eager(plan, make_body: Callable, carry, *, generator=None,
                   noise_fn: Optional[Callable] = None,
                   on_step: Optional[Callable] = None,
                   on_chunk: Optional[Callable] = None):
    """Run a plan ``[(seg_fuse, seg_irr, tables), ...]`` one body call a
    step, eagerly (the CPU's runner; on the card the reference the graph
    runner is held against). ``make_body(seg_fuse, seg_irr)`` gives the
    body. ``on_step(i, carry, aux)`` runs after each step and
    ``on_chunk(chunk, n_steps, seg_fuse, seg_irr, latents)`` after each
    chunk. Returns the final carry."""
    dev = carry[0].device
    draw = _loop_draw(generator, noise_fn)
    bodies = {}
    for ci, (seg_fuse, seg_irr, xs) in enumerate(plan):
        kind = (seg_fuse, seg_irr)
        if kind not in bodies:
            bodies[kind] = make_body(seg_fuse, seg_irr)
        tab = torch.from_numpy(np.stack(xs, axis=1)).to(dev)
        for j in range(tab.shape[0]):
            carry, aux = bodies[kind](carry, tab[j].unbind(0), draw)
            if on_step is not None:
                on_step(int(xs[-1][j]), carry, aux)
        if on_chunk is not None:
            on_chunk(ci, tab.shape[0], seg_fuse, seg_irr, carry[0])
    return carry


def run_plan(plan, make_body: Callable, carry, *, graphs: Optional[bool] = None,
             **kw):
    """``run_plan_eager`` on the CPU; on the card, by default, the CUDA
    graph runner (``runtime/step_graph.py::run_plan_graphs``), which
    raises rather than run eagerly when a capture or replay fails.
    ``graphs=False`` runs the card eagerly."""
    if graphs is None:
        graphs = carry[0].device.type == "cuda"
    if not graphs:
        return run_plan_eager(plan, make_body, carry, **kw)
    from worldforge_tpu_torch.runtime.step_graph import run_plan_graphs
    return run_plan_graphs(plan, make_body, carry, **kw)


def wan_denoise_scan(
    model_fn: Callable,
    latents: torch.Tensor,
    sched: FlowUniPCSchedule,
    guidance: GuidanceConfig,
    *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    fuse_fn: Optional[Callable] = None,
    flf_fn: Optional[Callable] = None,
    record_r0: bool = True,
    exec_chunk: int = 0,
    fuse_cost: float = 0.5,
    on_step: Optional[Callable] = None,
    on_chunk: Optional[Callable] = None,
) -> torch.Tensor:
    """The whole Wan denoise loop (IRR, the pixel-space fuse, FLF selected
    on the device, DSG) over its segments: one chunk a segment, or chunks
    of ``exec_chunk`` plain-step equivalents (``wan_scan_chunks``; the same
    result bit for bit). model_fn(latents, t) -> velocity with t a 0-dim
    tensor (CFG inside); fuse_fn(x0, step) -> fused x0; flf_fn(pre, fused,
    step) -> (x0, mask). The re-noise comes from ``noise_fn(shape)`` when
    given, else from ``generator``. Runs through ``run_plan``."""
    fuse_on = fuse_fn is not None
    sched_plan = wan_scan_chunks(sched, guidance, fuse_on,
                                 exec_chunk or 10 ** 9, fuse_cost=fuse_cost)
    m0 = torch.zeros_like(latents)
    m1 = torch.zeros_like(latents)

    def make_body(seg_fuse, seg_irr):
        return make_wan_body(model_fn, fuse_fn, flf_fn, guidance, record_r0,
                             seg_fuse, seg_irr)

    carry = run_plan(sched_plan, make_body, (latents, m0, m1),
                     generator=generator, noise_fn=noise_fn,
                     on_step=on_step, on_chunk=on_chunk)
    return carry[0]


def longcat_denoise_scan(
    model_fn: Callable,
    latents: torch.Tensor,
    sched,
    guidance: GuidanceConfig,
    *,
    generator: Optional[torch.Generator] = None,
    noise_fn: Optional[Callable] = None,
    fuse_fn: Optional[Callable] = None,
    exec_chunk: int = 0,
    on_step: Optional[Callable] = None,
) -> torch.Tensor:
    """The whole LongCat i2v denoise loop, as ``wan_denoise_scan``.
    model_fn(latents_full, t) -> the NEGATED velocity (CFG-zero inside);
    fuse_fn(x0_full, step) -> fused full-latent x0."""
    fuse_on = fuse_fn is not None
    plan = longcat_scan_chunks(sched, guidance, fuse_on,
                               exec_chunk or 10 ** 9)

    def make_body(seg_fuse, seg_irr):
        return make_longcat_body(model_fn, fuse_fn, guidance, seg_fuse,
                                 seg_irr)

    carry = run_plan(plan, make_body, (latents,), generator=generator,
                     noise_fn=noise_fn, on_step=on_step)
    return carry[0]
