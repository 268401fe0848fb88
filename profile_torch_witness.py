#!/usr/bin/env python3
"""Profile one warm call of the provers' witness map on one GPU, or time
chip_smoke's kernel phases alone.

    python3 profile_torch_witness.py                     # all four shapes
    python3 profile_torch_witness.py --only north_star seeded
    python3 profile_torch_witness.py --kernels [2 2b 2c 2d 2e 2f] [--sass] [--out FILE]
    python3 profile_torch_witness.py --times {2,2f} [--out FILE]
    python3 profile_torch_witness.py --peak CELL [--out FILE]
    python3 profile_torch_witness.py --setup             # CSR derivation in setups
    python3 profile_torch_witness.py --row-lengths [--small]   # CPU, no GPU

The squaring chain (`models.synthetic`) at the benchmark's shapes, through
the calls the provers make:

* `north_star`: `prover_witness_map_chunked` at Rq N=8192, L=1, M=2^18
  (eight 1024-slot chunks; `streamed.stream_prove`);
* `seeded`: the same at M=2^16 (`seeded.prover_seeded`);
* `rinocchio`: `witness_map_kernel_chunked(outputs="mid")` at M=2^16 with
  random d1, d2, d3 (`streamed.stream_prove_rinocchio`, ZK on);
* `zq`: `prover_witness_map_chunked` over Z_q, N=1, L=3, M=2^18.

Each shape: one cold call (plans, tables), then one warm call inside a
`torch.profiler` window (`bench_torch.measure.Window`): the wall time, the
device's idle share over the window, the NTT kernels' device time and share
of it, the device operations with the most time, and how many times the
window called the torch ops of the int64 map (`HOST_OPS`), and the torch
ops whose kernels took the most device time.  The outputs of
the warm call must equal the cold call's (their sums and every 4093rd
word).  One JSON line a shape, and all of them in
`chiprun_out/profile_witness.json`.

`--kernels`: chip_smoke's kernel phases alone (all six where none is
named): 2 (`kernel_vs_plain`: the NTT kernel in every mode at the paths'
shapes), 2b (`split_vs_plain`: the split transform to 2^19 and the two CTA
orders), 2c (`large_split_vs_plain`: the split past 2^19), 2d
(`prng_vs_plain`: the draws, the lift with its error and alone,
`encrypt_kernel` with c1 and with c0 alone), 2e (`mac_vs_plain`: `mac` and
`mac_drawn`), 2f (`witness_vs_plain`: `spmv` and `mulmod`), each kernel
against its plain version at the paths' shapes and timed beside its bound,
and their reports as one JSON line (also written to `--out`), so two trees
of the package compare in turns (a copy of this script and `chip_smoke.py`
beside each package; parent, change, change, parent in one call).  With
`--sass`, first the build's ptxas lines (registers, spills) and
`scripts/sass_mix`'s instruction counts for the hash kernels and the NTT
(`SASS`; needs `cuobjdump`).
`--times PHASE`: one kernel alone, timed and not compared with anything,
so a build whose kernel was cut down on purpose (no butterflies, no
gathers, no store, ...) times as the whole kernel does; one JSON line.
Phase 2, the NTT kernel: every mode at phase 2's shapes and the north
star's [32, 6, 8192], and the split at the streamed witness map's 2^19
forward and 2^18 inverse, eagerly (CUDA events around 20 calls) and from a
replayed CUDA graph, beside the bound (`chip_smoke.ntt_bound`).  Phase 2f,
`spmv` at `chip_smoke.spmv_cases`' shapes, timed as phase 2f times it
(eager and as a CUDA graph, each call after an L2 eviction) beside the
same bound.
`--peak CELL`: one run of the benchmark's cell (`bench_torch.run.run`, as
`python3 -m bench_torch.run --cell CELL` runs it) under the allocator's
history (`torch.cuda.memory._record_memory_history`): `peak_gib` (bytes
allocated, the blocks the caching allocator handed out) beside the peak of
the bytes requested, and at the moment the history's live blocks peak,
those blocks summed by the port's innermost frame that allocated them
(file:line and function), the largest first; one JSON line.  Two trees'
lines, diffed, say which allocations a change moved.
`--setup`: the resident cell's setup (`rq8192_g16_resident_2e14`, as
`bench_torch.run` times it, each from a freed card) three times in one
process, the first cold, with the time of every `relations.r1cs.derive_csr`
inside it (the instance map's transposed CSRs; a synchronize around each).
These need a GPU and exit nonzero without one.

`--row-lengths`: how long the rows of the witness map's sparse products
are, on the CPU: for the five circuits of `models/` at their published
shapes (`--small`: test sizes) and the benchmark's squaring chain, each
matrix's row lengths (nonzeros per constraint) and its transposed ones
(per variable: the instance map's rows), binned by powers of two, with the
long-row length and the rows that `derive_csr` lists as long (each a work
item of its own in `spmv_kernel`).
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

SHAPES = ("north_star", "seeded", "rinocchio", "zq")
OUT = Path(__file__).resolve().parent / "chiprun_out" / "profile_witness.json"
PHASES = {"2d": ("prng", "prng_vs_plain"), "2e": ("mac", "mac_vs_plain"),
          "2f": ("witness", "witness_vs_plain")}
NTT_PHASES = ("2", "2b", "2c")
TIMES = ("2", "2f")  # --times: the NTT kernel, spmv
# the kernels that hash, and the NTT
SASS = ("lift_kernel", "encrypt_kernel", "mac_drawn_kernel", "ntt_kernel")


def ptxas_lines(log: str) -> list:
    """ptxas's register and spill lines for the kernels of SASS."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = next((k for k in SASS if k in m.group(1)), None)
            if name:
                out.append(m.group(1))
        elif name and ("registers" in line or "spill" in line):
            out.append("  " + line.strip())
    return out


def kernels(phases, sass: bool) -> dict:
    """chip_smoke's `phases` on this tree, with the SASS counts where `sass`."""
    import chip_smoke
    from ringsnark_tpu_torch.ops import cuda_ntt

    build = chip_smoke.build_kernels()
    result = {"gpu": chip_smoke.gpu_line(), "tree": str(cuda_ntt.__file__)}
    if sass:
        from ringsnark_tpu_torch.scripts import sass_mix

        result["ptxas"] = ptxas_lines(build.log or "")
        print("\n".join(result["ptxas"]), flush=True)
        result["sass"] = {k: v for k, v in sass_mix.report(build.path).items()
                          if k.startswith(SASS)}
        for name, r in sorted(result["sass"].items()):
            loops = [{k: v for k, v in lp.items() if k not in ("first", "last")}
                     for lp in r["loops"]]
            head = json.dumps({k: r[k] for k in ('instructions', 'alu', 'fma')})
            if "ntt" in r:
                print(f"sass {name}: {head} {json.dumps(r['ntt']['kernel'])} loops "
                      f"{json.dumps([lp['per_residue'] for lp in r['ntt']['loops']])}",
                      flush=True)
                continue
            print(f"sass {name}: {head} lift {json.dumps(r.get('lift'))} loops "
                  f"{json.dumps(loops)}", flush=True)
    if set(phases) & set(NTT_PHASES):
        result.update(ntt_phases(phases))
    for phase in phases:
        if phase in PHASES:
            key, fn = PHASES[phase]
            result[key] = getattr(chip_smoke, fn)(small=False)
    return result


def ntt_phases(phases) -> dict:
    """chip_smoke's phases 2, 2b and 2c (those of `phases`) at full size."""
    import chip_smoke
    from ringsnark_tpu_torch.ops import cuda_ntt

    out = {}
    if "2" in phases:
        params = chip_smoke.make_params(chip_smoke.FULL, "cuda")
        out["ntt"] = chip_smoke.kernel_vs_plain(params, chip_smoke.FULL)
    split = {m: {"max_abs_err": 0} for m in cuda_ntt.SPLIT_MODES}
    if "2b" in phases:
        params5 = chip_smoke.make_params(chip_smoke.FULL_SEEDED, "cuda")
        params7 = chip_smoke.make_params(chip_smoke.FULL_STREAMED, "cuda")
        split, out["cta_order"] = chip_smoke.split_vs_plain(params5, params7,
                                                            chip_smoke.FULL_SEEDED, False)
    if "2c" in phases:
        chip_smoke.large_split_vs_plain(split)
    if "2b" in phases or "2c" in phases:
        out["split"] = split
    return out


def ntt_times(iters: int = 20) -> list:
    """The rows of `--times 2` (module docstring)."""
    import chip_smoke
    from ringsnark_tpu_torch.ops import cuda_ntt
    from ringsnark_tpu_torch.ops import ntt as nttm
    from ringsnark_tpu_torch.ops.primes import find_ntt_primes

    params = chip_smoke.make_params(chip_smoke.FULL, "cuda")
    shapes = [s[:5] for s in chip_smoke.ntt_shapes(params, chip_smoke.FULL)]
    shapes.append(("north star", tuple(find_ntt_primes(6, 1 << 14)), 8192, True, 32))
    gen = torch.Generator(device="cuda").manual_seed(7)

    def residues(primes, rows, M):
        return torch.cat([torch.randint(0, p, (rows, 1, M), generator=gen, dtype=torch.int32,
                                        device="cuda") for p in primes], dim=1)

    out = []

    def row(label, x, inverse, nega, fn, split=False):
        ms, gms = chip_smoke.cuda_ms(fn, iters), chip_smoke.graph_ms(fn, iters)
        bms, by, bytes_ms, ops_ms = chip_smoke.ntt_bound(x, inverse, nega)
        r = dict(shape=f"{label} {list(x.shape)}", mode=("split_" if split else "")
                 + cuda_ntt.mode_name(inverse, nega), ms=ms, graph_ms=gms, bound_ms=bms,
                 bound_by=by, bytes_ms=bytes_ms, ops_ms=ops_ms, share_of_bound=bms / ms,
                 graph_share_of_bound=bms / gms)
        out.append(r)
        print(f"ntt {r['mode']:22s} {r['shape']:44s} {ms:.4f} ms (graph {gms:.4f}), bound "
              f"{bms:.4f} ms by {by}: {100 * bms / ms:.1f} % (graph {100 * bms / gms:.1f} %)",
              flush=True)

    for label, primes, size, nega, rows in shapes:
        x = residues(primes, rows, size)
        plan = nttm.get_plan(tuple(primes), size, negacyclic=nega)
        for inverse in (False, True):
            row(label, x, inverse, nega, lambda: cuda_ntt.ntt(x, plan, inverse, nega))
        del x
    primes = chip_smoke.make_params(chip_smoke.FULL_STREAMED, "cuda").ring.primes
    for log_m, inverse in ((19, False), (18, True)):
        x = residues(primes, 1024, 1 << log_m)
        plan = nttm.get_plan(tuple(primes), 1 << log_m)
        row("witness map", x, inverse, False,
            lambda: cuda_ntt.ntt_split(x, plan, inverse, False), split=True)
        del x
    torch.cuda.empty_cache()
    return out


def spmv_times() -> list:
    """The rows of `--times 2f` (module docstring)."""
    import chip_smoke

    chip_smoke.build_kernels()
    out = []
    for label, fn, _, ops, nbytes in chip_smoke.spmv_cases(False):
        ms, gms = chip_smoke.cold_ms(fn, False), chip_smoke.cold_ms(fn, True)
        bms, by = chip_smoke.prng_bound(ops, nbytes)
        out.append(dict(shape=label, ms=ms, graph_ms=gms, bound_ms=bms, bound_by=by,
                        share_of_bound=bms / ms, graph_share_of_bound=bms / gms))
        print(f"spmv {label:62s} {ms:.4f} ms (graph {gms:.4f}), bound {bms:.4f} ms by {by}: "
              f"{100 * bms / ms:.1f} % (graph {100 * bms / gms:.1f} %)", flush=True)
        del fn
    return out


def _frame(frames) -> str:
    """The innermost frame of the port (or of the benchmark) in `frames`."""
    for f in frames:
        name = f.get("filename", "")
        if "ringsnark_tpu_torch" in name or "bench_torch" in name:
            return f"{name.split('ringsnark_tpu_torch/')[-1]}:{f['line']} {f['name']}"
    return "other"


def peak(cell: str, top: int = 40) -> dict:
    """The row of `--peak CELL` (module docstring)."""
    from bench_torch import run

    torch.cuda.memory._record_memory_history(max_entries=4_000_000, stacks="python")
    try:
        row = run.run(cell)
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    stats = torch.cuda.memory_stats()
    events = snap["device_traces"][0] if snap["device_traces"] else []

    def replay(stop=None):
        """(live blocks after event `stop`, the peak of their bytes, its event)."""
        live, size, best, at = {}, 0, -1, -1
        for j, e in enumerate(events):
            if e["action"] == "alloc":
                live[e["addr"]] = (e["size"], e["frames"])
                size += e["size"]
            elif e["action"] == "free_completed" and e["addr"] in live:
                size -= live.pop(e["addr"])[0]
            if size > best:
                best, at = size, j
            if j == stop:
                break
        return live, best, at

    _, best, at = replay()
    groups = {}
    for nbytes, frames in replay(at)[0].values():
        g = groups.setdefault(_frame(frames), [0, 0])
        g[0] += nbytes
        g[1] += 1
    return {"cell": cell, "peak_gib": row["peak_gib"], "correct": row["correct"],
            "allocated_peak": stats["allocated_bytes.all.peak"],
            "requested_peak": stats["requested_bytes.all.peak"],
            "history_events": len(events), "history_peak": best,
            "at_peak": sorted(([k, *v] for k, v in groups.items()), key=lambda g: -g[1])[:top]}


def _setup(name: str):
    """(label, the map as a function of nothing) at shape `name`."""
    import chip_smoke
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.reductions import r1cs_to_qrp as red
    from ringsnark_tpu_torch.rings.elem import RingElem
    from ringsnark_tpu_torch.utils.domain import RootsDomain

    if name == "zq":
        params, log_m = chip_smoke.zq_params(3, 4096, 18), 18
    else:
        log_m = 18 if name == "north_star" else 16
        params = chip_smoke.make_params(dict(chip_smoke.FULL, log_m=log_m), "cuda")
    ring, M = params.ring, 1 << log_m
    comp, primary, aux = build_synthetic_square_chain(ring, M, np.random.default_rng(0))
    domain = RootsDomain(ring, M)
    label = f"{name}: N={ring.N} L={ring.L} M=2^{log_m}, n={ring.N}"
    if name != "rinocchio":
        return label, lambda: red.prover_witness_map_chunked(comp, primary.res, aux.res, domain)
    rng = np.random.default_rng(1)
    d1, d2, d3 = (RingElem.random_invertible_element(ring, rng).res for _ in range(3))
    full, io, mid = red._assignment_batches(ring, primary, aux)
    return f"{label}, outputs mid", lambda: red.witness_map_kernel_chunked(
        comp, full.res, io.res, mid.res, d1, d2, d3, domain, outputs="mid")


def _fingerprint(x: torch.Tensor) -> tuple:
    """The int64 sum of x and every 4093rd word of it."""
    return x.sum(dtype=torch.int64), x.flatten()[::4093].clone()


HOST_OPS = ("aten::remainder", "aten::index_add_", "aten::mul", "aten::cat", "aten::copy_",
            "aten::zeros", "aten::fill_", "aten::item", "aten::_local_scalar_dense")


def _host_ops(win) -> dict:
    """How many times the window called each of HOST_OPS (the torch ops of
    the int64 map: an int64 remainder, index_add_ or multiply shows here)."""
    raw = win.prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    counts = dict.fromkeys(HOST_OPS, 0)
    for e in raw:
        if e.device_type() == cpu and e.name() in counts:
            counts[e.name()] += 1
    return counts


def _ops_by_device_time(win, top: int = 12) -> list:
    """[torch op, device ms of the kernels it launched, calls] of the `top`
    torch ops (aten:: and the port's range) with the most device time: which
    call each copy and fill kernel came from."""
    rows = []
    for e in win.prof.key_averages():
        if e.key.startswith("aten::") or e.key == "witness_map":
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            rows.append([e.key, us / 1e3, e.count])
    return sorted(rows, key=lambda r: r[1], reverse=True)[:top]


def profile(name: str) -> dict:
    from bench_torch import measure

    label, run = _setup(name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = [_fingerprint(x) for x in run()]  # the outputs themselves would not fit twice
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    for attempt in (1, 2):  # a window of a few ms may come back without device events
        win = measure.Window("cuda")
        win.open("witness_map")
        warm = run()
        win.close()
        for a, b in zip(cold, warm):
            if not all(torch.equal(x, y) for x, y in zip(a, _fingerprint(b))):
                raise RuntimeError(f"{name}: the warm map differs from the cold one")
        try:
            row = measure.window_breakdown(win, top=12)
            break
        except RuntimeError:
            if attempt == 2:
                raise
    row["host_ops"] = _host_ops(win)
    row["ops_by_device_time"] = _ops_by_device_time(win)
    ntt_ms = row["ntt_device_ms"]
    busy_ms = row["window_s"] * 1e3 * (1 - row["device_idle_share"])
    return {"shape": name, "label": label, "cold_s": cold_s, "warm_s": win.wall_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "device_busy_ms": busy_ms, "outside_ntt_ms": busy_ms - ntt_ms,
            "ntt_share_of_busy": ntt_ms / busy_ms, **row}


def setup_cost(runs: int = 3) -> list:
    """[{setup_s, derive_csr_s: [s per derivation]}] of `runs` resident
    setups in this process, the first cold."""
    from bench_torch import cells
    from bench_torch.measure import build_kernels, timed
    from bench_torch.traffic import _setup, prepare
    from ringsnark_tpu_torch.relations import r1cs

    cell = cells.load("rq8192_g16_resident_2e14")
    build_kernels("cuda")
    params, circ = prepare(cell, "cuda", 0)
    derive, spent, rows = r1cs.derive_csr, [], []

    def timed_derive(*args):
        out, dt = timed(lambda: derive(*args), "cuda")
        spent.append(dt)
        return out

    r1cs.derive_csr = timed_derive
    try:
        for _ in range(runs):
            spent.clear()
            torch.cuda.empty_cache()
            kp, dt = timed(lambda: _setup(cell, params, circ, 0), "cuda")
            rows.append({"setup_s": dt, "derive_csr_s": list(spent)})
            del kp
    finally:
        r1cs.derive_csr = derive
    return rows


# the published shapes (chip_smoke.py's REFERENCE_CIRCUITS), and test sizes
CIRCUITS = {
    "toy": dict(N=1, n_inner=512, log_t=16, features=4),
    "plaintext_check": dict(N=2048, n_inner=16384, log_t=32, features=32),
    "ct_mul": dict(N=8192, n_inner=16384, log_t=16, features=32),
    "incircuit_ntt": dict(N=4096, n_inner=16384, log_t=16, features=32),
    "logreg": dict(N=2048, n_inner=16384, log_t=16, features=256),
}
SMALL_CIRCUIT = dict(N=64, features=8)


def histogram(lengths: torch.Tensor) -> dict:
    """{"0": rows with no nonzero, "1", "2", "3-4", "5-8", ...: rows}."""
    x = lengths.to(torch.int64)
    out = {"0": int((x == 0).sum()), "1": int((x == 1).sum())}
    lo, top = 2, int(x.max()) if x.numel() else 0
    while lo <= top:
        hi = 2 * (lo - 1) if lo > 2 else 2
        out[str(lo) if hi == lo else f"{lo}-{hi}"] = int(((x >= lo) & (x <= hi)).sum())
        lo = hi + 1
    return {k: v for k, v in out.items() if v}


def row_lengths(name: str, comp) -> dict:
    """The row-length histograms of every matrix of `comp`, both
    orientations, with the rows derive_csr lists as long."""
    row = {"system": name, "constraints": comp.num_constraints,
           "variables": comp.num_variables}
    for w, m in enumerate("ABC"):
        for transposed in (False, True):
            csr = comp.csr(w, transposed)
            n_out = comp.num_variables + 1 if transposed else comp.num_constraints
            lengths = torch.zeros(n_out, dtype=torch.int64)
            lengths[:csr.rows] = 1 if csr.unit else (csr.ptr[1:] - csr.ptr[:-1]).to(torch.int64)
            row[f"{m}{'^T' if transposed else ''}"] = {
                "nnz": int(csr.idx.numel()), "longest": csr.max_len, "long_len": csr.long_len,
                "long_rows": csr.nlong, "histogram": histogram(lengths)}
    return row


def _circuit(name: str, cfg: dict):
    from ringsnark_tpu_torch import models
    from ringsnark_tpu_torch.scripts.bench_circuits import make_params

    ring = make_params(cfg["N"], cfg["n_inner"],
                       max(4 * cfg["features"] + 8, cfg["N"] + 2, cfg["log_t"] + 2), "cpu").ring
    rng = np.random.default_rng(0)
    if name == "toy":
        pb = models.build_toy_circuit(ring, rng)
    elif name == "plaintext_check":
        pb = models.build_plaintext_check(ring, rng, log_t=cfg["log_t"])
    elif name == "ct_mul":
        pb = models.build_ct_mul(ring, rng, log_t=cfg["log_t"])
    elif name == "incircuit_ntt":
        pb = models.build_incircuit_ntt(ring, rng)
    else:
        pb = models.build_logreg_inference(ring, rng, num_features=cfg["features"],
                                           log_t=cfg["log_t"])
    return pb.compile()


def all_row_lengths(small: bool) -> list:
    """row_lengths of the five circuits and the squaring chain (M = 2^18, or
    2^10 where `small`), built on the CPU."""
    from ringsnark_tpu_torch.models.synthetic import build_synthetic_square_chain
    from ringsnark_tpu_torch.rings.context import default_context

    rows = []
    for name, cfg in CIRCUITS.items():
        if small:
            cfg = dict(cfg, **{k: min(v, cfg[k]) for k, v in SMALL_CIRCUIT.items()})
        rows.append(row_lengths(name, _circuit(name, cfg)))
    M = 1 << (10 if small else 18)
    ring = default_context(L=1, N=1, order=1 << 12, device="cpu")
    comp, _, _ = build_synthetic_square_chain(ring, M, np.random.default_rng(0))
    rows.append(row_lengths(f"squaring_chain M={M}", comp))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=SHAPES, default=list(SHAPES))
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", nargs="*", choices=sorted(PHASES) + list(NTT_PHASES),
                      metavar="PHASE", help="chip_smoke's kernel phases alone: 2, 2b, 2c, 2d, "
                      "2e, 2f (all where none)")
    mode.add_argument("--times", choices=TIMES, metavar="PHASE",
                      help="one kernel timed alone: 2 (the NTT), 2f (spmv)")
    mode.add_argument("--peak", metavar="CELL", help="a cell's run under the allocator's history")
    mode.add_argument("--setup", action="store_true", help="derive_csr in resident setups")
    mode.add_argument("--row-lengths", action="store_true", help="row-length histograms (CPU)")
    ap.add_argument("--small", action="store_true", help="--row-lengths at test sizes")
    ap.add_argument("--sass", action="store_true", help="--kernels: the hash kernels' SASS")
    ap.add_argument("--out", help="--kernels, --times, --peak: also write the JSON here")
    args = ap.parse_args(argv)
    if args.row_lengths:
        for row in all_row_lengths(args.small):
            print(json.dumps(row), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("profile_torch_witness: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    import chip_smoke

    print(f"gpu: {chip_smoke.gpu_line()}", flush=True)
    if args.kernels is not None or args.times or args.peak:
        from ringsnark_tpu_torch.ops import cuda_ntt

        head = {"gpu": chip_smoke.gpu_line(), "tree": str(cuda_ntt.__file__)}
        if args.times:
            text = json.dumps(dict(head, times=ntt_times() if args.times == "2" else spmv_times()))
        elif args.peak:
            text = json.dumps(dict(head, **peak(args.peak)))
        else:
            text = json.dumps(kernels(args.kernels or list(NTT_PHASES) + sorted(PHASES),
                                      args.sass))
        if args.out:
            Path(args.out).write_text(text)
        print(text, flush=True)
        return 0
    if args.setup:
        for row in setup_cost():
            print(f"setup {row['setup_s']:.4f} s, derive_csr "
                  f"{sum(row['derive_csr_s']):.4f} s in {len(row['derive_csr_s'])} calls: "
                  f"{json.dumps(row)}", flush=True)
        return 0
    rows = []
    for name in args.only:
        row = profile(name)
        rows.append(row)
        print(f"{row['label']}: warm {row['warm_s']:.4f} s (cold {row['cold_s']:.3f} s), device "
              f"busy {row['device_busy_ms']:.2f} ms, idle {100 * row['device_idle_share']:.1f} %, "
              f"NTT {row['ntt_device_ms']:.2f} ms ({100 * row['ntt_share_of_busy']:.1f} % of "
              f"busy), outside the NTT {row['outside_ntt_ms']:.2f} ms, peak "
              f"{row['peak_gib']:.3f} GiB", flush=True)
        print(f"  host ops {row['host_ops']}", flush=True)
        print(f"  torch ops by device time {row['ops_by_device_time']}", flush=True)
        for op, s, count in row["top_device_ops"]:
            print(f"  {1e3 * s:10.3f} ms  x{count:<6d} {op}", flush=True)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
