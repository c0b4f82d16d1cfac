#!/usr/bin/env python
"""Smoke run of the mapping engine on an NVIDIA GPU.

    python chip_smoke.py                # phases 1-4 on one card
    python chip_smoke.py --measure      # also time each kernel choice on v2
    python chip_smoke.py --kernels-only # phases 1-2
    python chip_smoke.py --multi        # the four-card phase, alone

Phases, in order; each prints one line of findings:

1. device   jax.devices() plus nvidia-smi's name and power limit; the
            platform must be "gpu" (no fallback to the CPU).
2. kernels  the Myers gap kernel (ops/gap_dp_pallas.py) against
            gap_dp.gap_align on the card at every configured gap bucket
            and its full G, on CLR-like related pairs with NW and SHW
            modes mixed (including the edlib negative-end SHW artifact),
            plus a sample against the host oracle (align/edlib_eq.py);
            the affine extension (ops/affine_pl.py) at every affine
            bucket, G=128, clip and split parameter sets, against the
            host ksw_extend2.  The tolerance is exact equality: all DP in
            ops/ is integer (no float matmul anywhere), so TF32 and
            summation order do not arise.
3. golden   the CLI --index / --search on tests/data must give SAM
            byte-equal to tests/data/golden.sam, @PG aside.
4. v2       the bench deployment (bench.gen_dataset, seed 1234: 28 Mb
            genome with repeat families, 512 CLR-like reads, 40
            SV/clip/inversion reads, 8 junk reads) into .bench_cache_big/:
            index built by the CLI, the full set mapped by the CLI on the
            card, steady-state reads/s from a warm engine pass, compile
            (warm-up) time, peak device memory, stage timers; then a
            subset (the 48 SV/junk reads + the first 64 CLR reads) mapped
            on the card and in a subprocess held to the CPU
            (JAX_PLATFORMS=cpu, no card) from the same index, SAM
            byte-equal.

--multi (four cards) runs only: the v2 subset with --shardIndex over the
four cards in one process, and with --numProcesses 4 --coordinator (one
process per card, merged SAM); both byte-equal to the single-card SAM.

Any failure exits non-zero with no result line.  On success the last line
of stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
Details too long for a line go to chiprun_out/smoke_*.json.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
WORK = ROOT / ".smoke_tmp"
SUBSET_CLR = 64


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def dump(name, obj):
    OUT.mkdir(exist_ok=True)
    (OUT / f"smoke_{name}.json").write_text(json.dumps(obj, indent=1))


def card_line():
    smi = shutil.which("nvidia-smi")
    check(smi is not None, "no nvidia-smi: no NVIDIA GPU here")
    r = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0 and r.stdout.strip(),
          f"nvidia-smi failed: {r.stderr.strip()}")
    return " | ".join(l.strip() for l in r.stdout.splitlines() if l.strip())


def body(path):
    """SAM lines without the @PG header (it carries the command line)."""
    return [l for l in Path(path).read_text().splitlines()
            if not l.startswith("@PG")]


def cli(*argv):
    from lordfast_tpu.cli import main

    rc = main([str(a) for a in argv])
    check(rc == 0, f"CLI {' '.join(map(str, argv))} returned {rc}")


# ---------------------------------------------------------------- phase 1
def phase_device(n_cards):
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found {devs[0].platform} devices")
    check(len(devs) >= n_cards, f"{len(devs)} GPUs, need {n_cards}")
    check(shutil.which("g++") is not None, "g++ missing: the native host "
          "library (lordfast_tpu/native) cannot be built")
    from lordfast_tpu.native import _load

    check(_load() is not None, "native host library failed to build/load")
    say("device", f"{devs} | {card_line()} | g++ native lib ok")
    return devs


# ---------------------------------------------------------------- phase 2
def _mutate(rng, q, err):
    """CLR-like copy: substitutions, insertions, deletions at err/3 each."""
    import numpy as np

    r = rng.random(len(q))
    out = np.where(r < err / 3, rng.integers(0, 4, len(q)), q)
    ins = (r >= err / 3) & (r < 2 * err / 3)
    keep = ~((r >= 2 * err / 3) & (r < err))
    rep = np.where(keep, 1 + ins, 0)
    out = np.repeat(out, rep)
    first = np.cumsum(rep) - rep               # first copy of each base
    extra = np.ones(len(out), bool)
    extra[first[keep]] = False
    out[extra] = rng.integers(0, 4, int(extra.sum()))
    return out.astype(np.uint8)


def _gap_batch(rng, G, Q, T):
    """G padded gap problems for bucket (Q, T): CLR-like related pairs,
    NW and SHW mixed; the first three are negative-end SHW artifacts."""
    import numpy as np

    qs = np.zeros((G, Q), np.uint8)
    ts = np.zeros((G, T), np.uint8)
    ql = np.zeros(G, np.int32)
    tl = np.zeros(G, np.int32)
    shw = rng.random(G) < 0.5
    for g in range(G):
        n = int(rng.integers(max(1, Q // 2), Q + 1))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = _mutate(rng, q, 0.12)
        if T > 2 * Q:   # SV-deletion shape: short query, long target
            k = int(rng.integers(0, len(t) + 1))
            fill = rng.integers(0, 4, int(rng.integers(T // 2, T)))
            t = np.concatenate([t[:k], fill, t[k:]]).astype(np.uint8)
        if shw[g]:      # trailing target is free in SHW
            t = np.concatenate([t, rng.integers(0, 4, T)]).astype(np.uint8)
        t = t[:T] if len(t) else np.zeros(1, np.uint8)
        qs[g, :n], ts[g, : len(t)] = q, t
        ql[g], tl[g] = n, len(t)
    for g, (q, t) in enumerate([([0], [1, 1, 1]), ([2, 2], [0, 1, 3, 3]),
                                ([1, 3, 0], [2, 2, 2, 2, 2])][: G]):
        qs[g], ts[g] = 0, 0
        qs[g, : len(q)], ts[g, : len(t)] = q, t
        ql[g], tl[g], shw[g] = len(q), len(t), True
    return qs, ql, ts, tl, shw


def _timeit(fn, reps):
    import jax

    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return first, (time.perf_counter() - t0) / reps, out


def phase_kernels():
    import jax
    import numpy as np

    from lordfast_tpu.align import edlib_eq as ed
    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.ops import affine_pl, gap_dp
    from lordfast_tpu.ops import gap_dp_pallas as gp

    cfg = LordfastConfig()
    rng = np.random.default_rng(1234)
    rows = []
    for Q, T, G in cfg.gap_buckets:
        qs, ql, ts, tl, shw = (jax.device_put(a)
                               for a in _gap_batch(rng, G, Q, T))
        kc, kt, kres = _timeit(
            lambda: gp.gap_align_pl(qs, ql, ts, tl, shw, Q, T), 3)
        dc, dt_, dres = _timeit(
            lambda: gp.gap_align_pl(qs, ql, ts, tl, shw, Q, T,
                                    with_path=False), 3)
        jc, jt, jres = _timeit(
            lambda: gap_dp.gap_align(qs, ql, ts, tl, shw, Q, T), 1)
        kres, dres, jres = jax.device_get((kres, dres, jres))
        for name in ("dist", "end"):
            check(np.array_equal(getattr(kres, name), getattr(jres, name)),
                  f"myers {Q}x{T}: kernel {name} != gap_align")
            check(np.array_equal(getattr(dres, name), getattr(jres, name)),
                  f"myers {Q}x{T}: no-path kernel {name} != gap_align")
        kmv = gp.decode_col_moves(np.asarray(kres.colcode), kres.end,
                                  kres.lead)
        jmv = gap_dp.unpack_moves(np.asarray(jres.moves_packed), jres.mlen)
        for g in range(G):
            check(np.array_equal(kmv[g], jmv[g]),
                  f"myers {Q}x{T}: gap {g} path differs from gap_align")
        h = [jax.device_get(a) for a in (qs, ql, ts, tl, shw)]
        for g in list(range(3)) + list(rng.choice(G, 5, replace=False)):
            q, t = h[0][g, : h[1][g]], h[2][g, : h[3][g]]
            if h[4][g]:
                d, e, mv = ed.shw_path(q, t)
            else:
                (d, mv), e = ed.nw_path(q, t), len(t) - 1
            check((kres.dist[g], kres.end[g]) == (d, e)
                  and np.array_equal(kmv[g], mv),
                  f"myers {Q}x{T}: gap {g} differs from the host oracle")
        cells = G * Q * T
        rows.append(dict(Q=Q, T=T, G=G, kernel_ms=kt * 1e3,
                         kernel_nopath_ms=dt_ * 1e3, jnp_ms=jt * 1e3,
                         kernel_gcells=cells / kt / 1e9,
                         kernel_nopath_gcells=cells / dt_ / 1e9,
                         jnp_gcells=cells / jt / 1e9,
                         kernel_first_s=kc, kernel_nopath_first_s=dc,
                         jnp_first_s=jc))

    mat = ed.build_ksw_matrix(cfg.ksw_match_clip, cfg.ksw_mismatch_clip)
    w_max = max(cfg.clip_band, cfg.split_band)
    BW = 128 * ((2 * w_max + 2 + 127) // 128)
    clip = (cfg.ksw_gap_open_clip, cfg.ksw_gap_extend_clip,
            cfg.ksw_gap_open_clip, cfg.ksw_gap_extend_clip,
            cfg.clip_band, cfg.clip_zdrop)
    split = (cfg.split_o_del, cfg.split_e_del, cfg.split_o_ins,
             cfg.split_e_ins, cfg.split_band, cfg.split_zdrop)
    arows = []
    for Qe, Te, _ in cfg.affine_buckets:
        G = 128
        qs = np.zeros((G, Qe), np.uint8)
        ts = np.zeros((G, Te), np.uint8)
        par = {k: np.zeros(G, np.int32) for k in
               ("o_del", "e_del", "o_ins", "e_ins", "w_eff", "zdrop", "h0")}
        probs = []
        for g in range(G):
            n = int(rng.integers(max(1, Qe // 2), Qe + 1))
            q = rng.integers(0, 4, n).astype(np.uint8)
            t = _mutate(rng, q, 0.12)
            if g % 4 == 3:   # junk tail: the extension z-drops
                k = int(rng.integers(0, len(t)))
                t = np.concatenate([t[:k], rng.integers(0, 4, Te)])
            t = t[:Te].astype(np.uint8)
            ps = clip if g % 2 == 0 else split
            qs[g, :n], ts[g, : len(t)] = q, t
            od, ed_, oi, ei, w, zd = ps
            for k, v in zip(("o_del", "e_del", "o_ins", "e_ins", "zdrop",
                             "h0"), (od, ed_, oi, ei, zd, n)):
                par[k][g] = v
            par["w_eff"][g] = affine_pl.clamp_band(n, cfg.ksw_match_clip,
                                                   0, od, ed_, oi, ei, w)
            probs.append((q, t, ps))
        ql = np.array([len(p[0]) for p in probs], np.int32)
        tl = np.array([len(p[1]) for p in probs], np.int32)
        run = lambda: affine_pl.extend_batch(
            qs, ts, Qe, Te, BW, w_max, qlen=ql, tlen=tl,
            match=np.full(G, cfg.ksw_match_clip, np.int32),
            mismatch=np.full(G, cfg.ksw_mismatch_clip, np.int32), **par)
        ac, at, res = _timeit(run, 3)
        res = jax.device_get(res)
        for g, (q, t, (od, ed_, oi, ei, w, zd)) in enumerate(probs):
            want = ed.ksw_extend2(q, t, mat, od, ed_, oi, ei, w, 0, zd,
                                  len(q), with_max_off=True)
            got = tuple(int(x[g]) for x in res)
            check(got == want, f"affine {Qe}x{Te}: problem {g} {got} != "
                  f"host {want}")
        arows.append(dict(Qe=Qe, Te=Te, G=G, ms=at * 1e3, first_s=ac))
    dump("kernels", {"myers": rows, "affine": arows})
    msg = "; ".join(
        f"{r['Q']}x{r['T']}/G{r['G']}: kernel {r['kernel_ms']:.3f} ms "
        f"({r['kernel_gcells']:.2f} Gcell/s, no-path "
        f"{r['kernel_nopath_ms']:.3f} ms) vs jnp {r['jnp_ms']:.3f} ms "
        f"({r['jnp_gcells']:.3f})" for r in rows)
    amsg = "; ".join(f"{r['Qe']}x{r['Te']}/G{r['G']}: {r['ms']:.2f} ms"
                     for r in arows)
    say("kernels", f"myers exact (dist/end/path) vs gap_align and host "
        f"oracle at {len(rows)} buckets: {msg} | affine exact "
        f"(score/qle/tle/gtle/gscore/max_off) vs host at {len(arows)} "
        f"buckets: {amsg}")


# ---------------------------------------------------------------- phase 3
def phase_golden():
    data = ROOT / "tests" / "data"
    d = WORK / "golden"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in ("ref.fa", "reads.fq"):
        shutil.copy(data / f, d / f)
    t0 = time.time()
    cli("--index", d / "ref.fa")
    cli("--search", d / "ref.fa", "--seq", d / "reads.fq", "-o",
        d / "out.sam")
    ours, gold = body(d / "out.sam"), body(data / "golden.sam")
    check(ours == gold, "golden: SAM differs from tests/data/golden.sam "
          f"({sum(a != b for a, b in zip(ours, gold))} lines differ, "
          f"{len(ours)} vs {len(gold)} lines)")
    say("golden", f"CLI SAM byte-equal to golden.sam ({len(gold)} lines, "
        f"@PG aside) in {time.time() - t0:.1f} s")


# ---------------------------------------------------------------- phase 4
def v2_setup():
    """Generate the v2 set (if absent), build its index with the CLI and
    write the subset FASTQ.  Host-only: opens no card."""
    sys.path.insert(0, str(ROOT))
    import bench

    cache = bench.CACHE_DIR
    cache.mkdir(exist_ok=True)
    ref, reads = cache / "bench_ref.fa", cache / "bench_reads.fq"
    tag = cache / "DATASET_TAG"
    t0 = time.time()
    if not (ref.exists() and reads.exists() and tag.exists()
            and tag.read_text() == bench.DATASET_TAG):
        bench.gen_dataset(cache)
    t_gen = time.time() - t0
    from lordfast_tpu.index.builder import index_path_for

    t0 = time.time()
    if not index_path_for(ref).exists():
        cli("--index", ref)
    t_index = time.time() - t0
    from lordfast_tpu.io.fastx import read_fastx

    sub = WORK / "v2_subset.fq"
    WORK.mkdir(exist_ok=True)
    n_clr, n = 0, 0
    with open(sub, "w") as f:
        for r in read_fastx(reads):
            keep = r.name.startswith(("sv", "junk"))
            if not keep and n_clr < SUBSET_CLR:
                keep, n_clr = True, n_clr + 1
            if keep:
                f.write(f"@{r.name}\n{r.seq}\n+\n{r.qual}\n")
                n += 1
    check(n == SUBSET_CLR + bench.N_SV + bench.N_GARBAGE,
          f"v2 subset has {n} reads")
    return ref, reads, sub, t_gen, t_index


def cpu_subprocess(ref, seq, out):
    """Map on the CPU in a child that never opens the card
    (JAX_PLATFORMS=cpu, no visible CUDA device); the child keeps off the
    first cores so this process's host threads are not starved."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    cores = sorted(os.sched_getaffinity(0))
    spare = cores[4:] if len(cores) >= 8 else cores
    argv = ["--search", str(ref), "--seq", str(seq), "-o", str(out)]
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [sys.executable, "-c",
         f"import os, sys; os.sched_setaffinity(0, {spare!r}); "
         f"from lordfast_tpu.cli import main; sys.exit(main({argv!r}))"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def timed_engine(idx, reads, **kw):
    """Warm pass (compiles) + timed pass through MappingEngine.map_file;
    returns (warm_s, timed_s, n_reads, metrics)."""
    from lordfast_tpu.config import LordfastConfig
    from lordfast_tpu.pipeline.engine import MappingEngine

    eng = MappingEngine(idx, LordfastConfig(), **kw)
    with contextlib.redirect_stderr(io.StringIO()):
        t0 = time.time()
        eng.map_file(reads, io.StringIO(), "warm")
        warm = time.time() - t0
        n0 = eng.stats["reads"]
        t0 = time.time()
        eng.map_file(reads, io.StringIO(), "timed")
        dt = time.time() - t0
    m = eng.metrics
    return warm, dt, eng.stats["reads"] - n0, {
        "timers": {k: round(v, 4) for k, v in m.timers.items()},
        "counters": dict(m.counters)}


def phase_v2(ref, reads, sub, t_gen, t_index, cpu_job, measure):
    import jax

    from lordfast_tpu.index.builder import index_path_for, load_index

    d = WORK / "v2"
    d.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with contextlib.redirect_stderr(io.StringIO()):
        cli("--search", ref, "--seq", reads, "-o", d / "full_gpu.sam")
    t_cli = time.time() - t0
    n_full = sum(1 for l in body(d / "full_gpu.sam") if not l.startswith("@"))

    idx = load_index(index_path_for(ref))
    warm, dt, n, met = timed_engine(idx, reads)
    peak = jax.devices()[0].memory_stats().get("peak_bytes_in_use")
    rec = {"cli_cold_s": t_cli, "engine_warm_s": warm, "timed_s": dt,
           "reads": n, "reads_per_s": n / dt, "peak_bytes": peak,
           "gen_s": t_gen, "index_s": t_index, **met}
    if measure:
        # end-to-end choice of each kernel, in turns A B B A (the
        # default run above is the first A of the gap-kernel pair; the
        # third run here closes it and opens the escalation pair)
        from lordfast_tpu.ops import gap_dp_pallas as gp

        supports = gp.supports
        runs = []
        default = False   # MappingEngine's esc_device default
        for kern, esc in (("jnp", default), ("jnp", default),
                          ("pallas", default), ("pallas", not default),
                          ("pallas", not default), ("pallas", default)):
            gp.supports = supports if kern == "pallas" else (
                lambda Q, T: False)
            try:
                w, t, nr, mm = timed_engine(idx, reads, esc_device=esc)
            finally:
                gp.supports = supports
            runs.append({"gap_kernel": kern, "esc_device": esc,
                         "warm_s": w, "timed_s": t, "reads_per_s": nr / t,
                         **mm})
        rec["measure"] = runs
    dump("v2", rec)

    with contextlib.redirect_stderr(io.StringIO()):
        cli("--search", ref, "--seq", sub, "-o", d / "subset_gpu.sam")
    so, se = cpu_job.communicate(timeout=1800)
    check(cpu_job.returncode == 0, f"CPU subset run failed: {se[-2000:]}")
    gpu_b, cpu_b = body(d / "subset_gpu.sam"), body(d / "subset_cpu.sam")
    diff = [i for i, (a, b) in enumerate(zip(gpu_b, cpu_b)) if a != b]
    check(gpu_b == cpu_b, f"v2 subset: card SAM != CPU SAM "
          f"({len(gpu_b)} vs {len(cpu_b)} lines; first diffs at {diff[:5]})")
    t = met["timers"]
    stages = ", ".join(f"{k} {t[k]:.2f}s" for k in sorted(t))
    say("v2", f"{n_full} SAM records from the CLI on the card in "
        f"{t_cli:.1f} s (cold, incl. compile); steady state {n} reads in "
        f"{dt:.2f} s = {n / dt:.2f} reads/s; engine warm-up (compile) "
        f"{warm:.1f} s; peak device memory {peak / 2**30:.2f} GiB; index "
        f"build {t_index:.1f} s; stages: {stages}; subset of "
        f"{len([l for l in gpu_b if not l.startswith('@')])} records: "
        f"card SAM == CPU SAM")


# ------------------------------------------------------------------ multi
def free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_multi():
    # count the cards without starting JAX: the children open them first
    n = len(card_line().split(" | "))
    check(n >= 4, f"--multi needs four GPUs, nvidia-smi lists {n}")
    ref, _, sub, _, _ = v2_setup()
    d = WORK / "multi"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    # several chunks, so every process owns some
    chunk = ["--chunkSize", str(max(sub.stat().st_size // 8, 1))]
    merged = d / "merged.sam"
    port = free_port()
    t0 = time.time()
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "lordfast_tpu.cli", "--search", str(ref),
             "--seq", str(sub), "-o", str(merged), *chunk,
             "--numProcesses", "4", "--processIndex", str(i),
             "--coordinator", f"localhost:{port}"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for i in range(4)
    ]
    outs = [p.communicate(timeout=1500) for p in procs]
    for i, (p, (_, se)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"process {i} failed: {se[-2000:]}")
    t_procs = time.time() - t0
    # the children have exited: now this process opens the four cards
    devs = phase_device(4)
    t0 = time.time()
    with contextlib.redirect_stderr(io.StringIO()):
        cli("--search", ref, "--seq", sub, "-o", d / "single.sam", *chunk)
        t_single = time.time() - t0
        t0 = time.time()
        cli("--search", ref, "--seq", sub, "-o", d / "sharded.sam",
            "--shardIndex", *chunk)
        t_sharded = time.time() - t0
    single = body(d / "single.sam")
    check(body(d / "sharded.sam") == single,
          "--shardIndex over 4 cards: SAM != single-card SAM")
    check(body(merged) == single,
          "--numProcesses 4: merged SAM != single-card SAM")
    say("multi", f"v2 subset ({len(single)} lines): --shardIndex over "
        f"{len(devs)} cards == single card; --numProcesses 4 (one card "
        f"each, merged) == single card | wall: single {t_single:.1f} s, "
        f"sharded {t_sharded:.1f} s, 4 processes {t_procs:.1f} s "
        f"(all cold, incl. compile)")
    return devs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--measure", action="store_true",
                    help="also time v2 end to end with each gap kernel "
                         "and each escalation path")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run only phases 1-2")
    args = ap.parse_args()
    if not (ROOT / "lordfast_tpu" / "__init__.py").exists():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        if args.multi:
            devs = phase_multi()
        else:
            devs = phase_device(1)
            if not args.kernels_only:
                ref, reads, sub, t_gen, t_index = v2_setup()
                cpu_job = cpu_subprocess(ref, sub,
                                         WORK / "v2" / "subset_cpu.sam")
            try:
                phase_kernels()
                if not args.kernels_only:
                    phase_golden()
                    phase_v2(ref, reads, sub, t_gen, t_index, cpu_job,
                             args.measure)
            finally:
                if not args.kernels_only and cpu_job.poll() is None:
                    cpu_job.kill()
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
