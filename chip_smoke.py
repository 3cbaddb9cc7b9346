#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``waffle_con_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase, as the check runs it
    python3 chip_smoke.py --phases kernel --small   # build + quick check

Phases, one line each (every failure exits non-zero):

1. device: the card (``nvidia-smi``), torch, and the ``nvcc`` build of
   ``waffle_con_tpu_torch/csrc/run_extend.cu``.
2. kernel: the CUDA run kernel against its plain PyTorch version on the
   card, every output compared bitwise, on a small geometry (R=16, E=8)
   and the north-star geometry (R=256, W=514, 10 kb reads); times per
   step of both.
3. main: the north-star search — 256 reads x 10 kb at 1 % error,
   ``min_count=64``, ``initial_band=216`` — through ``ConsensusDWFA`` on
   ``cuda``; the consensus must equal the truth, the run kernel must have
   taken every run (its launch counter > 0, the plain loop never called).
4. oracle: 16 reads x 1 kb at 2 %: the ``"python"`` oracle and ``"torch"``
   on ``cuda`` give byte-identical results.

The last three lines are the card's name and power limit, the kernel
table (JSON), and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX or of ``waffle_con_tpu``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

#: the card's peak rates (NVIDIA H100 SXM data sheet): HBM bytes/s, and
#: 32-bit scalar operations/s (the float32 non-tensor rate)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: int32 operations per band cell per step: the column recurrence
#: (substitution test 2, diagonal and deletion adds 2, min 1, validity 3,
#: prefix-min 2, re-add and caps 3, column folds 3) plus the tip test 4
OPS_PER_CELL = 20


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", flush=True)
    return 1


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------
# phase 2: kernel against plain


def _scorer(reads, **cfg):
    from waffle_con_tpu_torch import CdwfaConfigBuilder
    from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

    b = CdwfaConfigBuilder().backend("torch").device("cuda")
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    return TorchScorer(reads, b.build())


def _case_state(sc, *, prefix=b"", late=()):
    """Root a branch, push ``prefix``, activate ``late`` reads at their
    offsets; returns the slot."""
    import numpy as np

    act = np.ones(sc.num_reads, dtype=bool)
    for r, _o in late:
        act[r] = False
    h = sc.root(act)
    for k in range(len(prefix)):
        sc.push(h, prefix[: k + 1])
    for r, o in late:
        sc.activate(h, r, o, prefix)
    return h


def _copy_state(state):
    return {k: v.clone() for k, v in state.items()}


def _compare(sc, slot, args, st_k, st_p, outs_k, outs_p):
    """Bitwise comparison of two runs' outputs and slot rows; returns
    (max_abs_err, steps, code, rec_count)."""
    import torch
    from waffle_con_tpu_torch.ops import run_kernel as rk

    R, A = sc._R, sc.num_symbols
    rk_, rs_k, rf_k = rk.fetch(*outs_k, R, A, args.max_steps)
    rp_, rs_p, rf_p = rk.fetch(*outs_p, R, A, args.max_steps)
    err = 0
    for name in rk.RunResult._fields:
        a, b = getattr(rk_, name), getattr(rp_, name)
        if hasattr(a, "shape"):
            if a.shape != b.shape:
                raise AssertionError(f"{name}: shape {a.shape} vs {b.shape}")
            if a.size:
                err = max(err, int(abs(a.astype("int64") - b.astype("int64")).max()))
        elif a != b:
            raise AssertionError(f"{name}: {a} vs {b}")
    if rk_.rec_count:
        err = max(err, int(abs(rs_k - rs_p).max()), int(abs(rf_k - rf_p).max()))
    clen = int(st_k["clen"][slot])
    for name in ("D", "e", "rmin", "er", "clen"):
        d = (st_k[name][slot].long() - st_p[name][slot].long()).abs().max()
        err = max(err, int(d))
    d = (st_k["cons"][slot, :clen].long() - st_p["cons"][slot, :clen].long())
    if d.numel():
        err = max(err, int(d.abs().max()))
    torch.cuda.synchronize()
    return err, rk_.steps, rk_.code, rk_.rec_count


def _run_args(sc, **kw):
    from waffle_con_tpu_torch.ops.run_kernel import RunArgs

    base = dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
                min_count=3, l2=False, max_steps=200, first_sym=-1,
                allow_records=True, wc=sc._wc, et=sc._et,
                a_real=sc.num_symbols)
    base.update(kw)
    return RunArgs(**base)


def _time_cuda(fn, reps):
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / reps


def _truncated(make):
    """Reads cut short by 0-3 symbols: runs pass through reached ends
    (absorbed records) before the dirty stop."""
    def make2():
        truth, reads = make()
        return truth, [r[: len(r) - (k % 4)] for k, r in enumerate(reads)]
    return make2


def _one_random_read(make):
    """Read 0 replaced by random symbols: its edit distance climbs until
    the band overflows (code 5)."""
    def make2():
        import numpy as np

        truth, reads = make()
        rng = np.random.default_rng(1)
        reads = list(reads)
        reads[0] = bytes(rng.integers(0, 4, size=len(reads[0])).astype(np.uint8))
        return truth, reads
    return make2


def kernel_cases(small_only: bool):
    """(label, make-reads, scorer config, run args, state spec) cases."""
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    def small(seed, err):
        return lambda: generate_test(4, 120, 10, err, seed=seed)

    cases = [
        ("small/clean", small(1, 0.0), {}, dict(max_steps=60), {}),
        ("small/err3", small(2, 0.03), {}, dict(max_steps=150), {}),
        ("small/early_term", small(3, 0.03),
         dict(allow_early_termination=True), dict(max_steps=150), {}),
        ("small/l2", small(4, 0.05), dict(allow_early_termination=True),
         dict(max_steps=120, l2=True), {}),
        ("small/forced", small(6, 0.02), {},
         dict(max_steps=40, first_sym=2), {}),
        ("small/budget", small(7, 0.0), {},
         dict(max_steps=30, me_budget=20), {}),
        ("small/records", _truncated(small(11, 0.0)), {},
         dict(max_steps=200), {}),
        ("small/overflow", _one_random_read(small(5, 0.0)), {},
         dict(max_steps=120), {}),
        ("small/offsets", small(9, 0.02), {}, dict(max_steps=100),
         dict(prefix_len=30, late=((3, 6), (7, 11)))),
    ]
    if small_only:
        return cases
    ns = lambda: generate_test(4, 10000, 256, 0.01, seed=0)  # noqa: E731
    ns_cfg = dict(min_count=64, initial_band=216)
    for label, make, cfg, kw, state in [
        ("clean", ns, {}, dict(max_steps=300), {}),
        ("l2", ns, {}, dict(max_steps=300, l2=True), {}),
        ("early_term", ns, dict(allow_early_termination=True),
         dict(max_steps=300), {}),
        ("forced", ns, {}, dict(max_steps=300, first_sym=1), {}),
        ("budget", ns, {}, dict(max_steps=300, me_budget=100), {}),
        ("offsets", ns, {}, dict(max_steps=300),
         dict(prefix_len=60, late=((5, 4), (17, 9), (200, 13)))),
        ("overflow", _one_random_read(ns), {}, dict(max_steps=1500), {}),
        # the main path's own launch: the root pop of the north-star
        # search (forced first symbol, the engine's step bound)
        ("main_launch", ns, {}, dict(max_steps=2 * 10000 + 256),
         dict(force_truth=True)),
        # north-star width (R=256, W=514) with short reads, so the run
        # reaches the read ends
        ("records", _truncated(
            lambda: generate_test(4, 400, 256, 0.01, seed=3)), {},
         dict(max_steps=600), {}),
    ]:
        cases.append(("north_star/" + label, make, {**ns_cfg, **cfg},
                      dict(min_count=64, **kw), state))
    return cases


def phase_kernel(small_only: bool):
    """Kernel vs plain on the card.  Returns the kernel table's numbers
    (from the main path's own launch, or the first small case with
    ``small_only``) and the max error over every compared output."""
    from waffle_con_tpu_torch.ops import run_kernel as rk

    max_err = 0
    timing = None
    cache = {}
    for label, make, cfg, kw, spec in kernel_cases(small_only):
        if make not in cache:
            cache[make] = make()
        truth, reads = cache[make]
        sc = _scorer(reads, **cfg)
        prefix = truth[: spec.get("prefix_len", 0)]
        h = _case_state(sc, prefix=prefix, late=spec.get("late", ()))
        slot = sc._slot_of[h]
        if spec.get("force_truth"):
            kw = dict(kw, first_sym=sc.sym_id[truth[0]])
        args = _run_args(sc, **kw)
        while len(prefix) + args.max_steps + 2 >= sc._C:
            sc._grow_cons()
        st0 = _copy_state(sc._state)
        st_k, st_p = _copy_state(st0), _copy_state(st0)
        outs_k = rk.run_extend_cuda(st_k, slot, sc._reads, sc._rlen, args)
        # the compared plain run is also the plain version's timing
        held = []
        p_ms = _time_cuda(lambda: held.append(rk.run_extend_plain(
            st_p, slot, sc._reads, sc._rlen, args)), 1)
        outs_p = held[0]
        err, steps, code, nrec = _compare(sc, slot, args, st_k, st_p,
                                          outs_k, outs_p)
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"{label}: kernel != plain (max err {err})")
        line = dict(case=label, steps=steps, code=code, records=nrec)
        if label.startswith("north_star/") or small_only:
            # every timed call starts from a fresh copy of the same state
            it = iter([_copy_state(st0) for _ in range(3)])
            k_ms = _time_cuda(
                lambda: rk.run_extend_cuda(next(it), slot, sc._reads,
                                           sc._rlen, args), 3)
            per = max(steps, 1)
            line.update(kernel_ms=round(k_ms, 4), plain_ms=round(p_ms, 3),
                        kernel_us_per_step=round(1000 * k_ms / per, 3),
                        plain_us_per_step=round(1000 * p_ms / per, 2))
            if label == "north_star/main_launch" or (
                small_only and timing is None
            ):
                R, W = sc._R, sc._W
                nbytes = 2 * R * W * 4 + R * (steps + W) * 2
                ops = steps * R * W * OPS_PER_CELL
                t_bytes = nbytes / PEAK_BYTES_S * 1e3
                t_ops = ops / PEAK_OPS_S * 1e3
                timing = dict(
                    ms=k_ms, plain_ms=p_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    steps=steps,
                )
        print("kernel", json.dumps(line), flush=True)
        del sc, st0, st_k, st_p
    return timing, max_err


# ---------------------------------------------------------------------
# phases 3 and 4


def phase_main():
    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusDWFA
    from waffle_con_tpu_torch.ops import run_kernel as rk
    from waffle_con_tpu_torch.utils.example_gen import generate_test
    import torch

    t0 = time.perf_counter()
    truth, reads = generate_test(4, 10000, 256, 0.01, seed=0)
    gen_s = time.perf_counter() - t0
    cfg = (CdwfaConfigBuilder().backend("torch").device("cuda")
           .min_count(64).initial_band(216).build())
    walls = []
    for run in ("cold", "warm"):
        eng = ConsensusDWFA(cfg)
        for r in reads:
            eng.add_sequence(r)
        rk.run_extend_cuda.launches = 0
        rk.run_extend_plain.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.consensus()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = rk.run_extend_cuda.launches
        plain_calls = rk.run_extend_plain.calls
        if not res or res[0].sequence != truth:
            raise AssertionError(f"{run}: consensus != truth")
        if launches <= 0 or plain_calls != 0:
            raise AssertionError(
                f"{run}: run kernel launches {launches}, plain calls "
                f"{plain_calls}"
            )
    device_ms = _profiled_kernel_ms(eng)
    st = eng.last_search_stats
    c = st["scorer_counters"]
    line = dict(
        reads=len(reads), length=len(truth), gen_s=round(gen_s, 3),
        cold_s=round(walls[0], 3), warm_s=round(walls[1], 3),
        pops=st["nodes_explored"] + st["nodes_ignored"],
        nodes_explored=st["nodes_explored"], run_calls=c["run_calls"],
        run_steps=c["run_steps"], kernel_launches=launches,
        plain_calls=plain_calls,
        steps_per_s=round(c["run_steps"] / walls[1], 1),
        push_calls=c["push_calls"], clone_push_calls=c["clone_push_calls"],
        grow_e_events=c["grow_e_events"], scores_sum=sum(res[0].scores),
        profiled_device_ms=device_ms,
        device_busy_share=(
            None if device_ms is None
            else round(device_ms / 1e3 / walls[1], 4)
        ),
    )
    print("main", json.dumps(line), flush=True)
    return launches


def _profiled_kernel_ms(eng):
    """Device time of every CUDA kernel of one more search of ``eng``'s
    reads, from ``torch.profiler`` (``{name: ms}``; ``None`` when the
    profiler saw no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.consensus()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        total += us
    return round(total / 1e3, 3) if total > 0 else None


def phase_oracle():
    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusDWFA
    from waffle_con_tpu_torch.utils.example_gen import generate_test

    truth, reads = generate_test(4, 1000, 16, 0.02, seed=1)
    got = {}
    for be in ("python", "torch"):
        eng = ConsensusDWFA(
            CdwfaConfigBuilder().backend(be).device("cuda").min_count(4)
            .build()
        )
        for r in reads:
            eng.add_sequence(r)
        got[be] = [(c.sequence, c.scores) for c in eng.consensus()]
    if got["python"] != got["torch"]:
        raise AssertionError("oracle: python and torch results differ")
    print("oracle", json.dumps(dict(
        results=len(got["torch"]), truth=got["torch"][0][0] == truth,
        identical=True,
    )), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernel,main,oracle",
                    help="phases after the build, comma-separated")
    ap.add_argument("--small", action="store_true",
                    help="kernel phase on the small geometry only")
    opts = ap.parse_args(argv)
    phases = opts.phases.split(",")
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    try:
        from waffle_con_tpu_torch.ops import run_kernel as rk
    except ImportError as exc:
        return fail(f"waffle_con_tpu_torch not importable: {exc}")

    smi = smi_line()
    t0 = time.perf_counter()
    rk.build(verbose=True)
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in rk.build_info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print("device", json.dumps(dict(
        smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=round(build_s, 2), nvcc_s=round(rk.build_info["seconds"], 2),
        ptxas=ptxas,
    )), flush=True)

    timing, max_err, launches = None, None, None
    if "kernel" in phases:
        timing, max_err = phase_kernel(opts.small)
    if "main" in phases:
        launches = phase_main()
    if "oracle" in phases:
        phase_oracle()

    print(smi)
    kernel = dict(
        name="run_extend", route="cuda",
        source="waffle_con_tpu_torch/csrc/run_extend.cu",
        replaces="waffle_con_tpu/ops/pallas_run.py:495",
        launches=launches, max_abs_err=max_err,
        ms=None if timing is None else timing["ms"],
        plain_ms=None if timing is None else timing["plain_ms"],
        bound_ms=None if timing is None else timing["bound_ms"],
        bound_by=None if timing is None else timing["bound_by"],
        library_ms=None,
    )
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
