"""Layered LDPC decoding for the DVB-T2 quasi-cyclic codes (EN 302 755
Annex A/B), with two implementations of one schedule.

Key observation: with checks reindexed as c = t + q*u (t in [0,q), u in
[0,360)), a parity-table entry (group g, base b) connects bit (g, m) to check
(t = b mod q, u = (b div q + m) mod 360).  So each entry is a *static cyclic
rotation*: the 360 checks of row t see bit-group g rotated by s = b div q.
The whole Tanner graph becomes a list of (layer t, group g, shift s) triples
and the decoder needs no gathers at all, only static-shift rolls of
(360, B) tiles and the q-layer serial schedule of the reference's layered
decoder (`LDPC/layered_decoder.hh:83-110`), which converges in roughly half
the sweeps of flooding.

The schedule (`_build_one_iteration`): offset min-sum, offset 0.5, any
static layer order, check-to-variable (c2v) messages optionally rounded to
bf16 storage while the bit totals stay float32.  The early-exit decoders
test the parity syndrome after every sweep (the reference's TRIALS + `bad()`
test, `LDPC/layered_decoder.hh:65-82`) and freeze each codeword from the
sweep it first checks clean, no earlier than a traced floor `min_it`:

  - `make_xla_decoder`: a `lax.while_loop` over sweeps, each a loop over
    a table of layers.  Any batch size; the CPU path and the reference at
    real widths.
  - `make_triton_decoder`: a Pallas kernel through Triton, one program per
    codeword running the whole early-exit decode itself.
  - `make_decoder` picks between them from `jax.default_backend()`.

`build_layered_stepper` / `build_layered_decoder` keep the schedule fully
unrolled (`_build_one_iteration`): the independent reference both early-
exit decoders are tested against, and the convergence studies' stepper.

Layout of the XLA form:
  total_info: (G+1, 360, B)  bit totals; group G is a +BIG dummy for padding
  total_par:  (q, 360, B)    parity totals, par[t, u] = bit k + t + q*u
  c2v:        (q, degmax+2, 360, B) check-to-variable messages, aligned to
              the check index u of layer t (info entries rolled by s)
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..dvbt2 import _etsi_tables as ET
from ..dvbt2.ldpc import _TABLE_KEY
from ..dvbt2.params import CodeRate, FECFrame

_BIG = 1e9


@dataclass(frozen=True, eq=False)
class QCTables:
    n: int
    k: int
    q: int
    n_groups: int
    degmax: int                    # max info entries per layer
    layer_deg: np.ndarray          # (q,)
    entry_g: np.ndarray            # (q, degmax) group index (G = dummy)
    entry_s: np.ndarray            # (q, degmax) shift


@functools.lru_cache(maxsize=None)
def qc_tables(frame: FECFrame, rate: CodeRate) -> QCTables:
    t = ET.LDPC_TABLES[_TABLE_KEY[(frame, rate)]]
    m_grp, n, k = t["M"], t["N"], t["K"]
    assert m_grp == 360
    r = n - k
    q = r // 360
    layers: list[list[tuple[int, int]]] = [[] for _ in range(q)]
    pos_iter = iter(t["POS"])
    grp = 0
    for deg, length in zip(t["DEG"], t["LEN"]):
        if deg == 0:
            break
        for _ in range(length):
            for _ in range(deg):
                b = next(pos_iter)
                layers[b % q].append((grp, b // q))
            grp += 1
    n_groups = grp
    degmax = max(len(x) for x in layers)
    layer_deg = np.array([len(x) for x in layers], dtype=np.int32)
    entry_g = np.full((q, degmax), n_groups, dtype=np.int32)
    entry_s = np.zeros((q, degmax), dtype=np.int32)
    for ti, ent in enumerate(layers):
        for j, (g, s) in enumerate(ent):
            entry_g[ti, j] = g
            entry_s[ti, j] = s
    return QCTables(n=n, k=k, q=q, n_groups=n_groups, degmax=degmax,
                    layer_deg=layer_deg, entry_g=entry_g, entry_s=entry_s)


def llrs_to_qc(tab: QCTables, llrs: np.ndarray):
    """(B, N) natural-order LLRs -> (total_info (G+1,360,B),
    total_par (q,360,B)) arrays."""
    b = llrs.shape[0]
    info = llrs[:, :tab.k].reshape(b, tab.n_groups, 360)
    total_info = np.empty((tab.n_groups + 1, 360, b), np.float32)
    total_info[:tab.n_groups] = np.moveaxis(info, 0, -1)
    total_info[tab.n_groups] = _BIG
    par = llrs[:, tab.k:].reshape(b, 360, tab.q)  # c = t + q*u -> [u, t]
    total_par = np.ascontiguousarray(
        np.moveaxis(par, 0, -1).transpose(1, 0, 2))  # (q, 360, B)
    return total_info.astype(np.float32), total_par.astype(np.float32)


def qc_to_bits(tab: QCTables, total_info: np.ndarray,
               total_par: np.ndarray) -> np.ndarray:
    """Final totals -> (B, N) hard bits."""
    b = total_info.shape[-1]
    info = np.moveaxis(total_info[:tab.n_groups], -1, 0).reshape(b, tab.k)
    par = np.moveaxis(total_par.transpose(1, 0, 2), -1, 0)  # (B, 360, q)
    out = np.concatenate([info, par.reshape(b, tab.n - tab.k)], axis=1)
    return (out < 0).astype(np.uint8)


def llrs_to_qc_jnp(tab: QCTables, llrs):
    """Device-side layout transform: (B, N) -> (total_info, total_par)."""
    b = llrs.shape[0]
    info = llrs[:, :tab.k].reshape(b, tab.n_groups, 360)
    total_info = jnp.concatenate(
        [jnp.moveaxis(info, 0, -1),
         jnp.full((1, 360, b), _BIG, llrs.dtype)], axis=0)
    par = llrs[:, tab.k:].reshape(b, 360, tab.q)
    total_par = jnp.moveaxis(par, 0, -1).transpose(1, 0, 2)
    return total_info, total_par


def qc_to_bits_jnp(tab: QCTables, total_info, total_par):
    """Device-side: final totals -> (B, N) hard bits (uint8)."""
    b = total_info.shape[-1]
    info = jnp.moveaxis(total_info[:tab.n_groups], -1, 0).reshape(b, tab.k)
    par = jnp.moveaxis(total_par.transpose(1, 0, 2), -1, 0).reshape(
        b, tab.n - tab.k)
    return (jnp.concatenate([info, par], axis=1) < 0).astype(jnp.uint8)


def llrs_nb_to_qc_jnp(tab: QCTables, llrs_t):
    """(N, B) transposed LLRs -> QC totals with NO batch transpose at all
    (the fused receive path emits this layout)."""
    b = llrs_t.shape[-1]
    info = llrs_t[:tab.k].reshape(tab.n_groups, 360, b)
    total_info = jnp.concatenate(
        [info, jnp.full((1, 360, b), _BIG, llrs_t.dtype)], axis=0)
    total_par = llrs_t[tab.k:].reshape(360, tab.q, b).transpose(1, 0, 2)
    return total_info, total_par


def qc_to_bits_nb_jnp(tab: QCTables, total_info, total_par):
    """Final totals -> (N, B) hard bits."""
    b = total_info.shape[-1]
    info = total_info[:tab.n_groups].reshape(tab.k, b)
    par = total_par.transpose(1, 0, 2).reshape(tab.n - tab.k, b)
    return (jnp.concatenate([info, par], axis=0) < 0).astype(jnp.uint8)


def _roll(x, s):
    """roll(x, s)[u] = x[u - s] along axis 0 (static s)."""
    s = int(s) % x.shape[0]
    if s == 0:
        return x
    return jnp.concatenate([x[-s:], x[:-s]], axis=0)


def _layer_order(q: int, layer_order) -> list:
    """Static layer visitation order for one sweep.  Any permutation is a
    valid layered schedule (each layer body indexes its own tables);
    tools/twophase_study.py --schedules measured REVERSED converging
    ~0.4 sweeps faster than natural at the 19 dB operating point (the
    natural order was the worst of all tried), so perf-critical callers
    pass reversed while the equivalence tests keep natural."""
    if layer_order is None:
        return list(range(q))
    if layer_order == "reversed":
        return list(range(q))[::-1]
    order = [int(t) for t in layer_order]
    assert sorted(order) == list(range(q))
    return order


def qc_syndrome_ok(frame: FECFrame, rate: CodeRate, total_info, total_par):
    """Per-codeword parity check from QC-layout totals (XLA, gather-free).

    Mirrors the layered schedule's alignment: check (t, u) sees info group g
    rolled by s, its own parity par[t, u], and the previous parity
    par[t-1, u] (par[q-1, u-1] for t=0; check 0 has none).  Equivalent of
    the reference decoder's `bad()` early-exit test
    (LDPC/layered_decoder.hh:65-82).  Returns (B,) bool.
    """
    return qc_syndrome_weight(frame, rate, total_info, total_par) == 0


def qc_syndrome_weight(frame: FECFrame, rate: CodeRate, total_info,
                       total_par):
    """Per-codeword count of FAILED parity checks ((B,) int32) — the
    `qc_syndrome_ok` computation with the count exposed (used as the
    difficulty signal in two-phase decode studies/scheduling)."""
    tab = qc_tables(frame, rate)
    hard_i = (total_info < 0).astype(jnp.int32)    # (G+1, 360, B)
    hard_p = (total_par < 0).astype(jnp.int32)     # (q, 360, B)
    b = total_info.shape[-1]
    bad = jnp.zeros((b,), jnp.int32)
    u0 = np.zeros((360, 1), np.int32)
    u0[0] = 1
    for t in range(tab.q):
        acc = hard_p[t]
        for j in range(int(tab.layer_deg[t])):
            g, s = int(tab.entry_g[t, j]), int(tab.entry_s[t, j])
            acc = acc + jnp.roll(hard_i[g], s, axis=0)
        if t > 0:
            acc = acc + hard_p[t - 1]
        else:
            # u=0 has no previous parity
            acc = acc + jnp.roll(hard_p[tab.q - 1], 1, axis=0) * (1 - u0)
        bad = bad + jnp.sum(jax.lax.rem(acc, 2), axis=0)
    return bad


def build_layered_stepper(frame: FECFrame, rate: CodeRate,
                          offset: float = 0.5, scale: float = 1.0,
                          c2v_dtype=None, layer_order=None):
    """One layered sweep over explicit state, jitted:
    fn(total_info, total_par, c2v) -> (total_info', total_par', c2v').

    The exact `build_layered_decoder` schedule with the c2v message state
    exposed, so convergence studies (tools/twophase_study.py) can observe
    per-sweep syndromes and snapshot posteriors without re-running from
    scratch.  `scale` multiplies the corrected magnitude (normalized
    min-sum; scale=1 offset=0.5 is the shipped decoder).  `c2v_dtype`
    (e.g. bf16) is the message storage precision: new messages round to
    that dtype at write-back and the rounded value feeds the total
    updates."""
    one_iteration = _build_one_iteration(qc_tables(frame, rate), offset,
                                         scale=scale, c2v_dtype=c2v_dtype,
                                         layer_order=layer_order)
    return jax.jit(lambda ti, tp, c2v: one_iteration((ti, tp, c2v)))


def build_layered_decoder(frame: FECFrame, rate: CodeRate, iters: int,
                          offset: float = 0.5):
    """Returns jitted fn(total_info, total_par) -> (total_info', total_par').

    Fixed-sweep form of the schedule (natural order, float32 messages),
    fully unrolled with static rolls; compiles once per (code, iters).
    """
    tab = qc_tables(frame, rate)
    q, degmax = tab.q, tab.degmax
    one_iteration = _build_one_iteration(tab, offset)

    def decode(total_info, total_par):
        b = total_info.shape[-1]
        c2v = jnp.zeros((q, degmax + 2, 360, b), total_info.dtype)
        state = (total_info, total_par, c2v)
        state = jax.lax.fori_loop(
            0, iters, lambda _, s: one_iteration(s), state)
        return state[0], state[1]

    return jax.jit(decode)


def _build_one_iteration(tab: QCTables, offset: float, scale: float = 1.0,
                         c2v_dtype=None, layer_order=None):
    q, degmax = tab.q, tab.degmax
    layer_deg = tab.layer_deg
    entry_g = tab.entry_g
    entry_s = tab.entry_s
    off = np.float32(offset)
    sc = np.float32(scale)
    order = _layer_order(q, layer_order)

    def one_iteration(state):
        total_info, total_par, c2v = state
        for t in order:
            deg = int(layer_deg[t])
            # gather v2c messages for this layer, aligned to check index u
            msgs = []
            for j in range(deg):
                g, s = int(entry_g[t, j]), int(entry_s[t, j])
                msgs.append(_roll(total_info[g], s) - c2v[t, j])
            # parity self + prev
            msgs.append(total_par[t] - c2v[t, degmax])
            if t > 0:
                prev = total_par[t - 1]
            else:
                prev = _roll(total_par[q - 1], 1)
            if t == 0:
                # check 0 has no previous parity: mask with +BIG on u==0
                u0 = np.zeros((360, 1), np.float32)
                u0[0] = _BIG
                msgs.append(prev - c2v[t, degmax + 1] + u0)
            else:
                msgs.append(prev - c2v[t, degmax + 1])
            # two-minimum + leave-one-out sign across the row
            mags = [jnp.abs(m) for m in msgs]
            negs = [(m < 0) for m in msgs]
            min1 = mags[0]
            min2 = jnp.full_like(mags[0], _BIG)
            amin = jnp.zeros_like(mags[0], dtype=jnp.int32)
            nneg = negs[0].astype(jnp.int32)
            for j in range(1, len(msgs)):
                is_new = mags[j] < min1
                min2 = jnp.where(is_new, min1, jnp.minimum(min2, mags[j]))
                min1 = jnp.where(is_new, mags[j], min1)
                amin = jnp.where(is_new, j, amin)
                nneg = nneg + negs[j].astype(jnp.int32)
            sign_all = 1.0 - 2.0 * (nneg % 2).astype(jnp.float32)
            new_c2v = []
            for j, m in enumerate(msgs):
                loo = jnp.where(amin == j, min2, min1)
                sgn = sign_all * jnp.where(negs[j], -1.0, 1.0)
                nc = sgn * (jnp.maximum(loo - off, 0.0) * sc)
                if c2v_dtype is not None:
                    # message storage precision: the stored
                    # (rounded) value feeds the total updates too
                    nc = nc.astype(c2v_dtype).astype(nc.dtype)
                new_c2v.append(nc)
            # write back ADDITIVELY (delta = new - old message) so a group
            # appearing twice in one layer composes instead of overwriting
            for j in range(deg):
                g, s = int(entry_g[t, j]), int(entry_s[t, j])
                delta = new_c2v[j] - c2v[t, j]
                total_info = total_info.at[g].add(_roll(delta, 360 - s))
                c2v = c2v.at[t, j].set(new_c2v[j].astype(c2v.dtype))
            total_par = total_par.at[t].set(msgs[deg] + new_c2v[deg])
            prev_new = msgs[deg + 1] + new_c2v[deg + 1]
            if t == 0:
                # aligned slot u maps to par[q-1][u-1]; slot u=0 is the
                # masked non-edge (check 0 has no previous parity), and
                # par[q-1][359] (the last parity bit) has no prev-edge
                # consumer -- keep its old total instead of the garbage
                # that would land there after the -1 roll.
                rolled = _roll(prev_new, 360 - 1)
                keep_last = np.zeros((360, 1), np.float32)
                keep_last[359] = 1.0
                total_par = total_par.at[q - 1].set(
                    rolled * (1.0 - keep_last)
                    + total_par[q - 1] * keep_last)
            else:
                total_par = total_par.at[t - 1].set(prev_new)
            c2v = c2v.at[t, degmax].set(new_c2v[deg].astype(c2v.dtype))
            c2v = c2v.at[t, degmax + 1].set(
                new_c2v[deg + 1].astype(c2v.dtype))
        return total_info, total_par, c2v

    return one_iteration


def make_decoder(frame: FECFrame, rate: CodeRate, max_iters: int = 24,
                 c2v_dtype=jnp.bfloat16, layer_order="reversed",
                 offset: float = 0.5):
    """The early-exit decoder for the backend in use:
    fn(llrs_t (N, B), min_it=0) -> (bits (N, B) uint8, sweeps ()).

    "gpu" gets the Triton kernel, which measured faster end to end on the
    H100 (PERF.md); "cpu" gets the XLA loop.  Any other backend raises, so
    nothing falls back silently."""
    backend = jax.default_backend()
    if backend == "gpu":
        build = make_triton_decoder
    elif backend == "cpu":
        build = make_xla_decoder
    else:
        raise RuntimeError(f"no LDPC decoder for backend {backend!r}")
    return build(frame, rate, max_iters=max_iters, c2v_dtype=c2v_dtype,
                 layer_order=layer_order, offset=offset)


def make_xla_decoder(frame: FECFrame, rate: CodeRate, max_iters: int = 24,
                     c2v_dtype=jnp.bfloat16, layer_order="reversed",
                     offset: float = 0.5):
    """Early-exit layered decoder in plain XLA:
    fn(llrs_t (N, B), min_it=0) -> (bits (N, B) uint8, sweeps ()).  Any
    batch size.

    A `lax.while_loop` over sweeps; each sweep is a `fori_loop` over a
    table of layers (`_sweep_over_table`), the `_build_one_iteration`
    schedule with the layer as a loop index, so the program stays small
    to compile on any backend.  After each sweep every codeword whose
    syndrome is clean, at a sweep count >= min_it, is frozen: later sweeps
    leave its totals and messages as they were.  The loop ends when all
    are frozen or at max_iters; `sweeps` is the sweep count at exit (the
    slowest codeword's)."""
    tab = qc_tables(frame, rate)
    sweep = _sweep_over_table(tab, offset, c2v_dtype, layer_order)
    msg_dtype = c2v_dtype or jnp.float32

    def decode(llrs_t, min_it=0):
        ti, tp = llrs_nb_to_qc_jnp(tab, llrs_t.astype(jnp.float32))
        b = ti.shape[-1]
        c2v = jnp.zeros((tab.q, tab.degmax + 2, 360, b), msg_dtype)
        min_it = jnp.asarray(min_it, jnp.int32)

        def cond(state):
            it, done = state[3], state[4]
            return jnp.logical_and(it < max_iters,
                                   jnp.logical_not(jnp.all(done)))

        def body(state):
            ti, tp, c2v, it, done = state
            new = sweep(ti, tp, c2v)
            ti, tp, c2v = (jnp.where(done, old, nw)
                           for old, nw in zip((ti, tp, c2v), new))
            it = it + 1
            ok = qc_syndrome_ok(frame, rate, ti, tp)
            done = jnp.logical_or(done, jnp.logical_and(ok, it >= min_it))
            return ti, tp, c2v, it, done

        ti, tp, _, it, _ = jax.lax.while_loop(
            cond, body, (ti, tp, c2v, jnp.int32(0), jnp.zeros((b,), bool)))
        return qc_to_bits_nb_jnp(tab, ti, tp), it

    return jax.jit(decode)


def _roll_dyn(x, s):
    """roll(x, s)[u] = x[u - s] along axis 0 for a traced s in [0, 360)."""
    return jax.lax.dynamic_slice_in_dim(
        jnp.concatenate([x, x], axis=0), 360 - s, 360, axis=0)


def _sweep_over_table(tab: QCTables, offset: float, c2v_dtype, layer_order):
    """One sweep of `_build_one_iteration`'s schedule as a `fori_loop`
    over `_kernel_tables` rows: fn(total_info, total_par, c2v) -> same.
    Padded info slots (layers below degmax) carry a +BIG message and
    write nothing, so results equal the unrolled sweep's."""
    q, dm = tab.q, tab.degmax
    tables = jnp.asarray(_kernel_tables(tab, _layer_order(q, layer_order)))
    off = np.float32(offset)
    u0 = np.zeros((360, 1), np.float32)
    u0[0] = _BIG
    keep_last = np.zeros((360, 1), np.float32)
    keep_last[359] = 1.0

    def layer(i, state):
        total_info, total_par, c2v = state
        row = tables[i]
        t, deg = row[0], row[1]
        first = t == 0
        msgs = []
        for j in range(dm):
            g, s = row[3 + j], row[3 + dm + j]
            m = _roll_dyn(total_info[g], s) - c2v[t, j]
            msgs.append(jnp.where(j < deg, m, np.float32(_BIG)))
        msgs.append(total_par[t] - c2v[t, dm])
        prev = jnp.where(first, _roll_dyn(total_par[q - 1], 1),
                         total_par[t - 1])
        m = prev - c2v[t, dm + 1]
        msgs.append(jnp.where(first, m + u0, m))
        mags = [jnp.abs(m) for m in msgs]
        negs = [(m < 0) for m in msgs]
        min1 = mags[0]
        min2 = jnp.full_like(mags[0], _BIG)
        amin = jnp.zeros_like(mags[0], dtype=jnp.int32)
        nneg = negs[0].astype(jnp.int32)
        for j in range(1, len(msgs)):
            is_new = mags[j] < min1
            min2 = jnp.where(is_new, min1, jnp.minimum(min2, mags[j]))
            min1 = jnp.where(is_new, mags[j], min1)
            amin = jnp.where(is_new, j, amin)
            nneg = nneg + negs[j].astype(jnp.int32)
        sign_all = 1.0 - 2.0 * (nneg % 2).astype(jnp.float32)
        new_c2v = []
        for j, m in enumerate(msgs):
            loo = jnp.where(amin == j, min2, min1)
            sgn = sign_all * jnp.where(negs[j], -1.0, 1.0)
            nc = sgn * jnp.maximum(loo - off, 0.0)
            if c2v_dtype is not None:
                nc = nc.astype(c2v_dtype).astype(nc.dtype)
            new_c2v.append(nc)
        # additive write-back in edge order: a group with two edges in
        # this layer composes instead of overwriting
        for j in range(dm):
            g, s = row[3 + j], row[3 + dm + j]
            live = j < deg
            delta = jnp.where(live, new_c2v[j] - c2v[t, j], 0.0)
            total_info = total_info.at[g].add(_roll_dyn(delta, (360 - s)
                                                        % 360))
            c2v = c2v.at[t, j].set(jnp.where(live, new_c2v[j], c2v[t, j])
                                   .astype(c2v.dtype))
        total_par = total_par.at[t].set(msgs[dm] + new_c2v[dm])
        prev_new = msgs[dm + 1] + new_c2v[dm + 1]
        # layer 0's previous parity is par[q-1] shifted by one check; the
        # last parity bit has no previous-parity edge and keeps its total
        rolled = _roll_dyn(prev_new, 359)
        last = (rolled * (1.0 - keep_last)
                + total_par[q - 1] * keep_last)
        total_par = total_par.at[jnp.where(first, q - 1, t - 1)].set(
            jnp.where(first, last, prev_new))
        c2v = c2v.at[t, dm].set(new_c2v[dm].astype(c2v.dtype))
        c2v = c2v.at[t, dm + 1].set(new_c2v[dm + 1].astype(c2v.dtype))
        return total_info, total_par, c2v

    return lambda ti, tp, c2v: jax.lax.fori_loop(0, q, layer, (ti, tp, c2v))


_LANES = 512          # one program's tile: the 360 checks of a layer, padded


def _kernel_tables(tab: QCTables, order) -> np.ndarray:
    """Per visit (layer position in the sweep order) one int32 row:
    [t, deg, has_dup, g_0.., s_0.., dup_0..] with degmax slots each.
    dup_j marks an info edge whose group an earlier edge of the same
    layer already touches; has_dup marks a layer with any such edge.
    Slots past deg name the dummy group G with shift 0."""
    dm = tab.degmax
    rows = np.zeros((tab.q, 3 + 3 * dm), np.int32)
    rows[:, 3:3 + dm] = tab.n_groups           # padding: the +BIG group
    for i, t in enumerate(order):
        deg = int(tab.layer_deg[t])
        g = [int(x) for x in tab.entry_g[t, :deg]]
        dup = [int(g[j] in g[:j]) for j in range(deg)]
        rows[i, :3] = (t, deg, int(any(dup)))
        rows[i, 3:3 + deg] = g
        rows[i, 3 + dm:3 + dm + deg] = tab.entry_s[t, :deg]
        rows[i, 3 + 2 * dm:3 + 2 * dm + deg] = dup
    return rows


def make_triton_decoder(frame: FECFrame, rate: CodeRate, max_iters: int = 24,
                        c2v_dtype=jnp.bfloat16, layer_order="reversed",
                        offset: float = 0.5, num_warps: int = 8,
                        interpret: bool = False):
    """The `make_xla_decoder` schedule as one Pallas kernel through Triton:
    fn(llrs_t (N, B), min_it=0) -> (bits (N, B) uint8, sweeps ()).

    One program per codeword runs that codeword's whole early-exit decode:
    every sweep, every layer, the syndrome test, and its own exit.  The
    layers are a loop over a small table (group, shift and flags of each
    edge), so the kernel's code is one layer's body.  A layer's cyclic
    shifts are address arithmetic on the loads and stores (lane u of the
    512-lane tile is check u), so no rolled copies exist; the layer's
    messages and its two-minimum state live in registers.  The float32
    totals and the c2v messages live in global memory, in per-codeword
    regions that stay in L1/L2 across layers.

    Layer t+1 reads totals that other threads of the program wrote in
    layer t, so a CTA barrier (`debug_barrier`, bar.sync, which orders the
    block's global stores before its later loads) closes every layer; a
    layer where one group has two edges also needs one between its reads
    and its writes, and one before the second edge adds its delta.
    Interpret mode runs a program's lanes in lockstep and needs none.

    Arithmetic is the XLA schedule's, operation for operation, so bits and
    sweep counts agree with `make_xla_decoder` exactly.  (Layers with
    fewer than degmax info edges pad with a +BIG message, which changes
    no minimum, sign or store.)"""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    tab = qc_tables(frame, rate)
    q, k, n, dm = tab.q, tab.k, tab.n, tab.degmax
    tables = jnp.asarray(_kernel_tables(tab, _layer_order(q, layer_order)))
    width = tables.shape[1]
    E = dm + 2                                 # c2v slots per layer
    n_tot = n + 1                              # + a spare for masked lanes
    n_c2v = q * E * 360 + 1
    L = _LANES
    off = np.float32(offset)
    big = np.float32(_BIG)
    zero = np.float32(0)
    msg_dtype = c2v_dtype or jnp.float32

    def kernel(min_it_ref, tbl_ref, llr_ref, tot_ref, c2v_ref, sweeps_ref):
        b = pl.program_id(0)
        u = jax.lax.iota(jnp.int32, L)
        valid = u < 360
        tb = b * n_tot
        cb = b * n_c2v
        t_spare = tb + n
        c_spare = cb + n_c2v - 1

        def tot_at(rel, mask):
            return tot_ref.at[jnp.where(mask, tb + rel, t_spare)]

        def load(ref, mask):
            return plgpu.load(ref, mask=mask, other=0.0).astype(jnp.float32)

        def barrier():
            if not interpret:
                plgpu.debug_barrier()

        def when(flag, fn, carry):
            """fn(carry) if the scalar flag is 1 (uniform across the
            program, so a barrier inside is legal); a loop of 0 or 1 trips
            because the Triton lowering rejects a cond with a constant
            branch."""
            return jax.lax.fori_loop(0, flag, lambda _, c: fn(c), carry)

        def init_totals(i, c):
            rel = i * L + u
            m = rel < n
            v = plgpu.load(llr_ref.at[jnp.where(m, b * n + rel, 0)], mask=m,
                           other=0.0)
            plgpu.store(tot_at(rel, m), v.astype(jnp.float32), mask=m)
            return c

        def init_c2v(i, c):
            rel = i * L + u
            m = rel < n_c2v - 1
            plgpu.store(c2v_ref.at[jnp.where(m, cb + rel, c_spare)],
                        jnp.zeros((L,), msg_dtype), mask=m)
            return c

        jax.lax.fori_loop(0, -(-n // L), init_totals, 0)
        jax.lax.fori_loop(0, -(-(n_c2v - 1) // L), init_c2v, 0)
        barrier()

        def edges(i):
            """Visit i's layer: its index t, flags, and per edge j the
            total index each lane reads and writes, the c2v slot and the
            lane mask (info edges first, then own and previous parity)."""
            row = i * width
            t = tbl_ref[row]
            deg = tbl_ref[row + 1]
            has_dup = tbl_ref[row + 2]
            first = t == 0
            rels, masks, dups = [], [], []
            for j in range(dm):
                g = tbl_ref[row + 3 + j]
                sh = tbl_ref[row + 3 + dm + j]
                rels.append(g * 360 + (u - sh + 360) % 360)
                masks.append(jnp.logical_and(valid, j < deg))
                dups.append(tbl_ref[row + 3 + 2 * dm + j])
            rels.append(k + t * 360 + u)
            masks.append(valid)
            rels.append(jnp.where(first, k + (q - 1) * 360 + (u + 359) % 360,
                                  k + (t - 1) * 360 + u))
            masks.append(valid)
            slots = [(t * E + j) * 360 + u for j in range(E)]
            return t, deg, has_dup, first, rels, masks, dups, slots

        def layer(i, c):
            t, deg, has_dup, first, rels, masks, dups, slots = edges(i)
            c2v_at = [c2v_ref.at[jnp.where(m, cb + sl, c_spare)]
                      for m, sl in zip(masks, slots)]
            tots = [load(tot_at(r, m), m) for r, m in zip(rels, masks)]
            olds = [load(ref, m) for ref, m in zip(c2v_at, masks)]
            msgs = [a - o for a, o in zip(tots, olds)]
            for j in range(dm):
                # a padded info slot: +BIG changes no minimum or sign
                msgs[j] = jnp.where(masks[j], msgs[j], big)
            # check 0 has no previous parity: +BIG on lane u == 0
            msgs[-1] = jnp.where(first,
                                 msgs[-1] + jnp.where(u == 0, big, zero),
                                 msgs[-1])
            mags = [jnp.abs(m) for m in msgs]
            negs = [m < 0 for m in msgs]
            min1 = mags[0]
            min2 = jnp.full((L,), big, jnp.float32)
            amin = jnp.zeros((L,), jnp.int32)
            nneg = negs[0].astype(jnp.int32)
            for j in range(1, E):
                is_new = mags[j] < min1
                min2 = jnp.where(is_new, min1, jnp.minimum(min2, mags[j]))
                min1 = jnp.where(is_new, mags[j], min1)
                amin = jnp.where(is_new, j, amin)
                nneg = nneg + negs[j].astype(jnp.int32)
            sign_all = 1.0 - 2.0 * (nneg % 2).astype(jnp.float32)
            # a group with two edges here: every lane must have read it
            # before any lane writes it
            when(has_dup, lambda z: (barrier(), z)[1], 0)
            for j in range(E):
                loo = jnp.where(amin == j, min2, min1)
                sgn = sign_all * jnp.where(negs[j], np.float32(-1),
                                           np.float32(1))
                stored = (sgn * jnp.maximum(loo - off, zero)).astype(
                    msg_dtype)
                new = stored.astype(jnp.float32)
                plgpu.store(c2v_at[j], stored, mask=masks[j])
                if j < dm:
                    # a repeated group: add this edge's delta on top of
                    # the earlier edge's write, in edge order
                    cur = when(dups[j], lambda z, j=j: (
                        barrier(), load(tot_at(rels[j], masks[j]),
                                        masks[j]))[1], tots[j])
                    plgpu.store(tot_at(rels[j], masks[j]),
                                cur + (new - olds[j]), mask=masks[j])
                elif j == dm:
                    plgpu.store(tot_at(rels[j], valid), msgs[j] + new,
                                mask=valid)
                else:
                    # lane 0 of layer 0 would land on the last parity bit,
                    # which has no previous-parity edge: leave it
                    keep = jnp.logical_and(
                        valid, jnp.logical_not(jnp.logical_and(first,
                                                               u == 0)))
                    plgpu.store(tot_at(rels[j], keep), msgs[j] + new,
                                mask=keep)
            barrier()
            return c

        def syndrome_layer(i, bad):
            _, _, _, first, rels, masks, _, _ = edges(i)
            masks[-1] = jnp.logical_and(
                masks[-1], jnp.logical_not(jnp.logical_and(first, u == 0)))
            acc = jnp.zeros((L,), jnp.int32)
            for r, m in zip(rels, masks):
                acc = acc + (load(tot_at(r, m), m) < 0).astype(jnp.int32)
            return bad + jnp.sum(acc % 2)

        floor = min_it_ref[0]

        def cond(c):
            it, done = c
            return jnp.logical_and(it < max_iters, done == 0)

        def body(c):
            it, _ = c
            jax.lax.fori_loop(0, q, layer, 0)
            it = it + 1
            # the syndrome pass runs only from the floor on
            bad = when((it >= floor).astype(jnp.int32),
                       lambda z: jax.lax.fori_loop(0, q, syndrome_layer,
                                                   jnp.int32(0)),
                       jnp.int32(1))
            return it, (bad == 0).astype(jnp.int32)

        it, _ = jax.lax.while_loop(cond, body, (jnp.int32(0), jnp.int32(0)))
        sweeps_ref[b] = it

    def decode(llrs_t, min_it=0):
        bsz = llrs_t.shape[-1]
        v = jnp.transpose(llrs_t)                              # (B, N)
        # parity bit k + t + q*u -> QC order (t, u)
        par = v[:, k:].reshape(bsz, 360, q).transpose(0, 2, 1)
        flat = jnp.concatenate([v[:, :k], par.reshape(bsz, n - k)],
                               axis=1).reshape(-1)
        mi = jnp.asarray(min_it, jnp.int32).reshape(1)
        call = pl.pallas_call(
            kernel,
            grid=(bsz,),
            out_shape=(jax.ShapeDtypeStruct((bsz * n_tot,), jnp.float32),
                       jax.ShapeDtypeStruct((bsz * n_c2v,), msg_dtype),
                       jax.ShapeDtypeStruct((bsz,), jnp.int32)),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
            interpret=interpret,
            name="ldpc_layered_decode",
        )
        tot, _, sweeps = call(mi, tables.reshape(-1), flat)
        tot = tot.reshape(bsz, n_tot)
        info = tot[:, :k]
        par = tot[:, k:n].reshape(bsz, q, 360).transpose(0, 2, 1)
        bits = jnp.concatenate([info, par.reshape(bsz, n - k)], axis=1) < 0
        return jnp.transpose(bits).astype(jnp.uint8), jnp.max(sweeps)

    return jax.jit(decode)
