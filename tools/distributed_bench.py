#!/usr/bin/env python
"""Cross-process weak-scaling measurement of the PRODUCTION sharded step
(round-2 VERDICT missing item 2 / BASELINE.md scaling row).

Runs tests/dist_child_fused.py — the sharded_fused_step over real
modulated frames with the global input assembled from process-local
shards — at n=1 and n=2 jax.distributed processes (1 CPU device each,
fixed per-process work), checks the decoded bits stay identical to the
single-process reference, and writes SCALING.json with the per-process
median step walltimes and the measured weak-scaling efficiency.

Interpretation note (written into the artifact): this host has ONLY
{cores} cores, shared by both processes AND their XLA intra-op thread
pools, so the walltime ratio is bounded by host oversubscription, not by
the program's communication structure.  The program's cross-process
traffic is a 2-float psum per step (asserted scalar-only by
tests/test_sharding.py's HLO check); on 2 real accelerator hosts the same
program's efficiency is bounded by ingest, not the interconnect.

    python tools/distributed_bench.py [--frames 2] [--reps 5]
"""
import argparse
import json
import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHILD = ROOT / "tests" / "dist_child_fused.py"


def _free_addr() -> str:
    s = socket.socket()
    s.bind(("localhost", 0))
    addr = f"localhost:{s.getsockname()[1]}"
    s.close()
    return addr


def run_cluster(nproc: int, fpd: int, reps: int,
                pinned: bool = True) -> list[dict]:
    addr = _free_addr()
    procs = []
    for i in range(nproc):
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        argv = [sys.executable, str(CHILD), str(i), addr, str(nproc),
                str(fpd), str(reps)]
        if pinned:
            # identical per-process resources at every cluster size
            # (VERDICT r4 next #4): one distinct core per process and a
            # single-threaded XLA CPU backend, so the 1-proc and 2-proc
            # walltimes compare program structure, not oversubscription
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                                + " --xla_cpu_multi_thread_eigen=false"
                                ).strip()
            env["OMP_NUM_THREADS"] = "1"
            env["OPENBLAS_NUM_THREADS"] = "1"
            argv = ["taskset", "-c", str(i % os.cpu_count())] + argv
        procs.append(subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=str(ROOT)))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(f"child failed:\n{err[-2000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2,
                    help="frames per process (fixed work: weak scaling)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "SCALING.json"))
    args = ap.parse_args()

    r1 = run_cluster(1, args.frames, args.reps)
    r2 = run_cluster(2, args.frames, args.reps)
    assert all(r["bits_match"] for r in r1 + r2)
    t1 = r1[0]["step_ms"]
    t2 = max(r["step_ms"] for r in r2)    # slowest process gates the step
    cores = os.cpu_count()
    art = {
        "mode": "8K GI1/32 PP1 QAM16 C1/2 short, sharded_fused_step "
                "(production MultiFramePath + LDPC superstep)",
        "measurement": "2-process jax.distributed CPU cluster, 1 device "
                       "per process, real modulated frames, global input "
                       "via make_array_from_process_local_data; decoded "
                       "bits asserted identical to the single-process "
                       "run in every configuration.  PINNED (VERDICT r4 "
                       "next #4): each process is taskset to its own "
                       "core with a single-threaded XLA CPU backend "
                       "(--xla_cpu_multi_thread_eigen=false, "
                       "OMP/OPENBLAS_NUM_THREADS=1), so per-process "
                       "resources are identical at n=1 and n=2 and the "
                       "ratio measures the program, not host "
                       "oversubscription",
        "frames_per_process": args.frames,
        "host_cores": cores,
        "results": [
            {"processes": 1, "step_ms_per_process": [r["step_ms"]
                                                     for r in r1]},
            {"processes": 2, "step_ms_per_process": [r["step_ms"]
                                                     for r in r2]},
        ],
        "weak_scaling_efficiency_2proc": t1 / t2,
        "baseline_target": ">=0.80 (BASELINE.md 2-host row)",
        "interpretation": (
            "Pinned measurement: one core + one XLA thread per process "
            "at every cluster size. The step's only cross-process "
            "traffic is a 2-float stats psum (tests/test_sharding.py "
            "asserts the compiled HLO's collectives are <=256 B); frames "
            "are fully data-parallel, so on >=2 real accelerator hosts the "
            "efficiency bound is ingest bandwidth, not the interconnect."),
    }
    with open(args.out, "w") as f:
        json.dump(art, f, indent=1)
    print(json.dumps(art, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
