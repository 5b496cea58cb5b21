"""Multi-chip sharding of the receive pipeline (jax.sharding / pjit).

Mapping of the reference's concurrency (SURVEY.md §2.6) onto a device mesh:

  - `time` axis: T2 frames (time-blocks of the IQ stream) are data-parallel —
    the DSP analogue of sequence/context parallelism.  Each device demods its
    own frames; the serial sync-feedback of the reference
    (`dvbt2_demodulator.cpp:182-213`) is already broken by the feed-forward
    per-frame estimation, so no halo exchange is needed at frame granularity
    (each frame carries its own P1 + pilots).
  - `cw` axis: LDPC codewords within a frame batch — the wide version of the
    reference's 32-lane SIMD batching (`ldpc_decoder.h:28-50`).

Collectives ride the mesh: the global post-FEC statistics (bit/error counts)
are an all-reduce XLA inserts from the output sharding; nothing is hand-
scheduled.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..dvbt2.params import PLPParams, T2Params
from ..ops import ldpc as jldpc
from ..dvbt2 import ldpc as ldpcmod
from ..rx import jaxdemod


def make_mesh(n_devices: int | None = None,
              axis_names=("time", "cw")) -> Mesh:
    """1xN or MxN mesh over available devices: `time` outer, `cw` inner."""
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = np.array(devs[:n])
    # favor a 2D split when possible so both axes exercise collectives
    t = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            t = cand
            break
    return Mesh(devs.reshape(t, n // t), axis_names)


def sharded_receive_step(p: T2Params, plp: PLPParams, num_blocks: int,
                         mesh: Mesh, ldpc_iters: int = 8):
    """Jitted multi-chip receive step.

    fn(bodies (F, len_frame*symbol_size) complex64 sharded over `time`,
       inv_nvar scalar)
      -> (hard bits (F, num_blocks, n_ldpc) uint8 same sharding,
          global_stats (2,) replicated [total ones, total codewords])
    """
    fd = jaxdemod.get_frame_demod(p)
    path = jaxdemod.get_plp_path(plp, num_blocks)
    code = ldpcmod.get_code(plp.fec_frame, plp.rate)
    decode = jldpc._build_decoder(code, ldpc_iters, 0.5, jnp.float32)
    from ..dvbt2 import l1 as l1mod
    # L1 region size is mode-dependent; the PLP slice begins right after it.
    # For the fixed-mode step we precompute it from the builders.
    pre, _post = l1mod.build_l1(p, [plp])
    l1_cells = l1mod.L1_PRE_CELLS + pre.l1_post_size
    n_cells = num_blocks * plp.cells_per_fec_block

    in_shard = NamedSharding(mesh, P("time", None, None))
    cw_shard = NamedSharding(mesh, P(("time", "cw"), None))
    rep = NamedSharding(mesh, P())

    def step(bodies, inv_nvar):
        # demod + LLR: data-parallel over frames ("time" axis).
        # bodies: (F, len_frame*symbol_size, 2) float32 re/im pairs
        def per_frame(body2):
            cells2 = fd._fn(body2)
            sl = jax.lax.dynamic_slice(cells2, (l1_cells, 0), (n_cells, 2))
            return path._fn(sl, inv_nvar)
        llrs = jax.vmap(per_frame)(bodies)          # (F, nb, N)
        # FEC: reshard the flattened codeword batch over the WHOLE mesh —
        # XLA inserts the all-to-all; LDPC then runs fully parallel on both
        # axes (the wide version of the reference's 32-lane batching)
        f = llrs.shape[0]
        cw_llrs = llrs.reshape(f * num_blocks, -1)
        cw_llrs = jax.lax.with_sharding_constraint(cw_llrs, cw_shard)
        bits = decode(cw_llrs)
        # replicated global stats = cross-device all-reduce
        stats = jnp.stack([jnp.sum(bits, dtype=jnp.float32),
                           jnp.asarray(f * num_blocks, jnp.float32)])
        return bits, stats

    return jax.jit(step, in_shardings=(in_shard, rep),
                   out_shardings=(cw_shard, rep))


def sharded_fused_step(p: T2Params, plp: PLPParams, num_blocks: int,
                       frames_per_device: int, mesh: Mesh,
                       ldpc_iters: int = 4, with_frontend: bool = False,
                       sco: float = 2e-5):
    """Multi-chip step over the PRODUCTION fused path (rx.fusedpath
    MultiFramePath — the pipeline bench.py measures), via shard_map.

    Frames are the natural data-parallel unit (each carries its own P1 +
    pilots; the serial sync feedback of the reference is already broken by
    per-frame estimation), so the WHOLE mesh is one data axis for them:
    every device runs the full local demod+LLR+LDPC superstep on its own
    frames — zero cross-device traffic in steady state, exactly how a
    multi-host deployment divides a long capture into time blocks.  The
    replicated global stats are one small psum across the mesh.

    fn(bodies (n_dev*F, len_frame*symbol_size, 2) sharded over the mesh,
       inv_nvar ())
      -> (bits (n_dev*F, nb, n_ldpc) uint8 same sharding,
          stats (2,) replicated [total ones, total codewords])

    with_frontend=True prepends the device sample-domain front end
    (ops/frontend_device: DC/IQ estimate+correct, NCO, Farrow resampling
    from a device clock `sco` off): the input becomes RAW device-rate
    samples (n_dev*F, n_raw, 2) with n_raw = frontend_raw_len(p, sco),
    and the whole correction runs inside the per-device shard — the
    front end is per-frame feed-forward, so it shards exactly like the
    demod (no extra collectives).
    """
    from jax import shard_map
    from ..rx import fusedpath

    mf = fusedpath.MultiFramePath(p, plp, num_blocks, frames_per_device)
    code = ldpcmod.get_code(plp.fec_frame, plp.rate)
    decode = jldpc._build_decoder(code, ldpc_iters, 0.5, jnp.float32)
    axes = tuple(mesh.axis_names)
    fe = None
    if with_frontend:
        # the bench's exact head: the symbol-emitting fused front end
        # (DC/IQ + NCO + Farrow reading at the post-P1, post-guard grid)
        # feeding the demod's stripped-symbol entry, planar re/im
        from ..ops import frontend_device as fdev
        half = 8
        ratio = 1.0 + sco
        fe = fdev.make_frontend_symbols(p.len_frame, p.symbol_size,
                                        p.guard_size, p.sample_rate,
                                        p1_len=0, half=half,
                                        sym_order=mf.demod.sym_order,
                                        out_dtype=jnp.bfloat16)
        fe_args = (jnp.float32(0.0), jnp.float32(ratio),
                   jnp.float32(half * ratio), jnp.float32(0.0))

    def local(bodies, inv_nvar):
        if fe is not None:
            (sr, si), _, _ = fe(bodies[..., 0], bodies[..., 1], *fe_args)
            llrs = mf._fn_syms(sr, si, inv_nvar)
        else:
            llrs = mf._fn(bodies, inv_nvar)        # (N, nb, F) local
        lf = jnp.transpose(llrs, (2, 1, 0))        # (F, nb, N)
        f, nb, n = lf.shape
        bits = decode(lf.reshape(f * nb, n).astype(jnp.float32))
        stats = jnp.stack([jnp.sum(bits, dtype=jnp.float32),
                           jnp.asarray(f * nb, jnp.float32)])
        stats = jax.lax.psum(stats, axes)          # all-reduce
        return bits.reshape(f, nb, n), stats

    # check_vma off: the decoder's scan carries start as replicated zero
    # constants and become device-varying after one iteration, which the
    # varying-manual-axes checker rejects; the computation is per-device
    # data parallel by construction
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(axes, None, None), P()),
                   out_specs=(P(axes, None, None), P()),
                   check_vma=False)
    return jax.jit(fn)


def dryrun(p: T2Params, plp: PLPParams, num_blocks: int,
           n_devices: int) -> None:
    """Compile + execute one sharded step on tiny shapes (driver hook).

    Exercises BOTH sharded programs: the fused production path
    (shard_map over the whole mesh) and the v1 resharding step (frames
    over `time`, codeword batch all-to-all over the full mesh)."""
    mesh = make_mesh(n_devices)
    total = mesh.devices.size
    rng = np.random.default_rng(0)

    # 1. fused production path, one frame per device
    fstep = sharded_fused_step(p, plp, num_blocks, frames_per_device=1,
                               mesh=mesh, ldpc_iters=2)
    bodies = rng.normal(size=(total, p.len_frame * p.symbol_size, 2)
                        ).astype(np.float32)
    fbits, fstats = fstep(jnp.asarray(bodies), jnp.float32(1.0))
    jax.block_until_ready((fbits, fstats))
    assert fbits.shape == (total, num_blocks, plp.fec.n_ldpc)
    assert int(fstats[1]) == total * num_blocks

    # 1b. the same step from RAW device-rate samples: the sample-domain
    # front end (DC/IQ + NCO + resampling) sharded with the demod
    from ..ops.frontend_device import frontend_raw_len
    rstep = sharded_fused_step(p, plp, num_blocks, frames_per_device=1,
                               mesh=mesh, ldpc_iters=2,
                               with_frontend=True)
    n_raw = frontend_raw_len(p.len_frame * p.symbol_size, 2e-5)
    raw = rng.normal(size=(total, n_raw, 2)).astype(np.float32)
    rbits, rstats = rstep(jnp.asarray(raw), jnp.float32(1.0))
    jax.block_until_ready((rbits, rstats))
    assert rbits.shape == (total, num_blocks, plp.fec.n_ldpc)
    assert int(rstats[1]) == total * num_blocks

    # 2. v1 step (cross-mesh codeword reshard collective)
    step = sharded_receive_step(p, plp, num_blocks, mesh, ldpc_iters=2)
    bits, stats = step(jnp.asarray(bodies), jnp.float32(1.0))
    jax.block_until_ready((bits, stats))
    assert bits.shape == (total * num_blocks, plp.fec.n_ldpc)
    assert int(stats[1]) == total * num_blocks
