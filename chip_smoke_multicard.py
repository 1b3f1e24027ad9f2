#!/usr/bin/env python3
"""Smoke run of the PyTorch port's multi-card paths on four CUDA cards of one
host, over NCCL, one rank process per card (rank r on cuda:r).

    python3 chip_smoke_multicard.py [--phases dp,spatial,daemon,trainer]
                                    [--out chiprun_out/multicard.json]

It needs four cards: with fewer, or without the port beside it, it exits
non-zero at once. ``chip_smoke.py`` stays the one-card smoke; this script
imports its helpers (the process runner, free ports, the kernels' launch
counters, the traced replay, the gates of its phase train) and builds the
kernels once in this process before any rank starts. Every one-process
reference runs here, on card 0, while no rank runs; the flagship
(resnet18_multistage / upproj) at 450x800 and 5 sweeps throughout, with
seeded random weights, cuDNN's deterministic algorithms and IEEE float32.

Groups of phases (``--phases``), each phase printing one JSON line:
  dp       four ranks of this script (``--worker dp``) on the data mesh:
    dp           (a) float32, a global batch of 8 (2 rows a rank), 8 train
                 steps on their CUDA graph and the same 8 steps under
                 graphs.disable_graphs, step i from the one-process step's
                 parameters after its step i-1 (the float32 gradients are
                 ill-conditioned; each step is compared from the same
                 start): each step against the one-process step under
                 phase train's gates, the ranks' parameters bit-equal
                 after every step, the graph's sums and state bit-equal to
                 the eager run's, collectives a step as eager, 1 C and 106
                 of each D launch a step and rank, a traced replay on every
                 rank (kernels by symbol as counted, NCCL device kernels);
                 bfloat16 at 32 rows a rank (global 128) on a resident
                 batch, graph and eager: img/s of the four ranks, peak GiB
                 a rank; the flat gradient all-reduce's ms (and a bare
                 all-reduce of as many bytes)
    grad_accum   (b) --grad-accum 2 (global micro-batch 8): one step against
                 the one-process step under phase train's gates, then a
                 capture and a replay, replicas bit-equal, 2 C a step
    dp_eval      (c) the eval step on its graph: sums rtol 1e-4 of one
                 process, replays bit-equal to eager, 84 B + 1 C a call
  spatial  four ranks (``--worker spatial``), meshes (data 2, space 2),
           data 4 and (data 1, space 4) over one default group:
    spatial      (d) on (2, 2): a float32 Predictor forward of B=8 against
                 the one-process plain-kernel Predictor (rel RMSE <= 1e-5);
                 4 float32 train steps, graphed and eager, step i from the
                 one-process step's parameters after its step i-1, each
                 under phase train's gates, replicas bit-equal, graph
                 bit-equal to eager, halo exchanges and bytes a step as
                 eager, host seconds of eager calls only; a traced replay
                 (NCCL device kernels); the bfloat16 forward's replay 200
                 times, each map bit-equal (the PDL check of kernel B
                 after an NCCL kernel); bfloat16 B=8 train img/s and peak
                 GiB a rank beside one card's
    predictor_mesh (e) the float32 Predictor over (4,), (2, 2) and space 4
                 (900x1600, B=2) on its graphs: maps bit-equal to
                 disable_graphs and on every rank, rel RMSE <= 1e-5 of the
                 one-process Predictor (whole image), 84 B + 1 C a forward
  daemon   ``python -m radar_depth_tpu_torch.serve --spatial 2`` on four
           ranks (torchrun's variables, one process a card; SIGINT to rank
           0 alone), then ``--spatial 4`` on a 900x1600 run:
    daemon       (f) /healthz 503 then 200; B=1, 3 and 8 requests within
                 rel RMSE 1e-5 of one process's predict; 8 clients x 32
                 one-sample requests (req/s, p50/p99); a bad body answered
                 400 and the next request served; SIGINT: every rank exits
                 0 with equal dispatch counts; the leader's broadcast ms
                 and bytes
  trainer  ``torchrun --nproc-per-node 4`` of this script
           (``--trainer-worker``), which runs ``train.main.run`` (the flow
           of ``python -m radar_depth_tpu_torch.train.main``) and writes
           each rank's graph stats and epochs:
    trainer      (g) float32, global batch 16, 2 epochs on packed shards
                 (48 train, 16 val) written by
                 ``radar_depth_tpu_torch.generate_dataset``, at
                 TRAIN_LR (below), data-parallel
                 and with --spatial 2: test.csv within phase harness's
                 1e-3 of one process at the same global batch, "replicas
                 bit-equal on 4 ranks", the train step captured once a run
                 on every rank; a 1-epoch run resumed to 2 epochs bit-equal
                 to the straight run (rows and checkpoint); data_time and
                 gpu_time a rank; then data-parallel at train.main's
                 default learning rate against one process at it, under
                 the same gate (the one-process runs side by side on
                 cards 0 and 1); a ``trainer_leg`` line per leg
                 (and a ``daemon_leg`` line per daemon) as it ends
Then nvidia-smi's line for each card, ``nvidia-smi topo -m`` (the
interconnect; the device line adds card 0's NVLink status and the cards'
peer-access matrix), and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 4}}. A
failed check does not stop the later phases: each line lists what failed
(``failed``), and the script exits non-zero before its last line if any
did. --out is written after every phase. The CPU tests
(tests/test_torch_graphs_spatial.py, test_torch_graphs_predict_mesh.py,
test_torch_trainer_generator.py, test_torch_parallel_*.py) cover these
paths over gloo ranks; this script runs only on the cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import chip_smoke as cs

WORLD = 4
H, W = cs.H, cs.W  # 450x800
BIG_H, BIG_W = 900, 1600  # nuScenes' own resolution: space 4
B_DP = 8  # global float32 batch of (a) and (c), 2 rows a rank
DP_STEPS = 8
B_RANK_BF16 = 32  # rows a rank in (a)'s bfloat16 rate
RATE_WARM, RATE_TIMED = 3, 10  # steps of each rate: eager, capture, replay
SP_STEPS = 4
PDL_REPLAYS = cs.RACE_ITERS  # 200
B_BIG = 2
SERVE_TILE = cs.SERVE_TILE  # 8
SERVE_CLIENTS, SERVE_PER_CLIENT = 8, 32
CLIENTS_S = 180  # the clients' whole run: a daemon that stops answering
REQUEST_S = 60  # one request (chip_smoke.http's timeout, in this process)
TRAIN_B, TRAIN_N, VAL_N, TRAIN_EPOCHS = 16, 48, 16, 2
# (g)'s learning rate of the DP, --resume and --spatial 2 legs, a tenth of
# train.main's default: at 1e-2 the order of the float32 sums alone (one
# process against four ranks) moved epoch 1's test.csv by 7.5e-3 on the
# CPU at 96x128, past phase harness's 1e-3. (g) also runs DP at the
# default rate against one process at it, under the same gate: 5.2e-4 on
# four H100s at 450x800
TRAIN_LR = 1e-3
# each launch of rank processes (a hung collective is killed at this)
RANK_TIMEOUT_S = {"dp": 360, "spatial": 420, "daemon": 300, "trainer": 180}
FAIL_GRACE_S = 20  # the other ranks' time to end after one failed
SEED_WEIGHTS = 5
GRAPH = "graph"
EAGER = "eager"
HERE = os.path.dirname(os.path.abspath(__file__))


# ------------------------------------------------------------- helpers


def floats(d) -> dict:
    return {k: float(v) for k, v in d.items()}


def digest(a) -> str:
    """A map's bytes, hashed: ranks compare their maps through it."""
    return hashlib.sha256(a.tobytes()).hexdigest()[:16]


def free_card(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def graph_stats(calls, extra_eager=0) -> dict:
    """A ShapeGraphs' stats after ``calls`` calls at one key (and
    ``extra_eager`` under disable_graphs): call 1 eager, call 2 captured
    and replayed, later calls replayed."""
    return {"eager": 1 + extra_eager, "captures": min(calls - 1, 1),
            "replays": max(calls - 1, 0)}


def want_train_launches(micro=1) -> dict:
    k = cs.KERNELS
    return {k["A"]: 0, k["B"]: 0, k["C"]: micro,
            **cs.bn_train_launches(cs.FLAGSHIP_TRAIN_SITES, micro)}


def want_eval_launches() -> dict:
    k = cs.KERNELS
    return {k["A"]: 0, k["B"]: cs.EPILOGUE_SITES_PER_FORWARD, k["C"]: 1}


class Gates:
    """The checks of one phase: each failed one is kept, with its detail;
    the phase's line lists them and the script fails at its end."""

    def __init__(self):
        self.failed = []

    def check(self, ok, what, detail=None) -> bool:
        if not ok:
            self.failed.append(what if detail is None
                               else f"{what}: {str(detail)[:600]}")
        return bool(ok)


def rank_env(rank, port):
    """torchrun's variables of ``rank`` of WORLD on this host, one card a
    rank (LOCAL_RANK = rank)."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), PYTHONPATH=HERE)


def run_ranks(cmd, env_of, timeout, logs):
    """WORLD processes of ``cmd`` at once (rank r with ``env_of(r)``, each
    in its own session, its output in ``logs``/rank{r}.out and .err); as
    soon as one fails the others are killed after FAIL_GRACE_S, since they
    would wait in a collective until ``timeout``. Returns [(returncode,
    stdout tail, stderr tail)]."""
    os.makedirs(logs, exist_ok=True)
    files = [(open(os.path.join(logs, f"rank{r}.out"), "w+"),
              open(os.path.join(logs, f"rank{r}.err"), "w+"))
             for r in range(WORLD)]
    procs = [subprocess.Popen(cmd, cwd=HERE, env=env_of(r), stdout=o,
                              stderr=e, start_new_session=True)
             for r, (o, e) in enumerate(files)]
    deadline, failed_at = time.monotonic() + timeout, None
    try:
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.poll() for p in procs):
                failed_at = now
            if now > deadline or (failed_at is not None
                                  and now > failed_at + FAIL_GRACE_S):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    out = []
    for p, (o, e) in zip(procs, files):
        texts = []
        for f in (o, e):
            f.flush()
            f.seek(0)
            texts.append(f.read()[-4000:])
            f.close()
        out.append((p.returncode, *texts))
    return out


def launch_ranks(gates, group, root):
    """WORLD processes of ``--worker group root``; {rank: its JSON}, the
    failures in ``gates``."""
    port, = cs.free_ports()
    cmd = [sys.executable, os.path.abspath(__file__), "--worker", group,
           root]
    t0 = time.perf_counter()
    results = run_ranks(cmd, lambda r: rank_env(r, port),
                        RANK_TIMEOUT_S[group], os.path.join(root, "logs"))
    seconds = time.perf_counter() - t0
    lines = {}
    for rank, (rc, o, e) in enumerate(results):
        path = os.path.join(root, f"rank{rank}.json")
        if gates.check(rc == 0 and os.path.exists(path),
                       f"{group} rank {rank} exit {rc}",
                       f"{o[-1500:]}\n{e[-3000:]}"):
            with open(path) as f:
                lines[rank] = json.load(f)
    return lines, seconds


def write_rank(root, rank, out):
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


class Held:
    """A state dict seen as a model by ``chip_smoke.compare_steps``:
    ``names`` are its parameters."""

    def __init__(self, sd, names):
        self.sd, self.names = sd, names

    def named_parameters(self):
        return ((k, self.sd[k]) for k in self.names)

    def state_dict(self):
        return self.sd


def cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def compare_step(np, model, sums, before, want, want_sums, what):
    """``chip_smoke.compare_steps`` of this rank's model after a step
    against the one-process step's state ``want`` from ``before``."""
    names = [k for k, _ in model.named_parameters()]
    got = cpu_state(model)
    return cs.compare_steps(np, {k: v.double() for k, v in before.items()},
                            Held(got, names), Held(want, names), sums,
                            want_sums, what)


def states_equal(torch, a, b) -> bool:
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) for k in a)


def momentum(state):
    return [s["momentum_buffer"].detach().cpu().clone()
            for s in state.optimizer.state.values()]


# ------------------------------------------------- the rank workers


def worker_mesh(torch):
    """This rank's data mesh and where it runs."""
    from radar_depth_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh()
    return mesh, {"rank": mesh.rank, "world": mesh.world,
                  "backend": mesh.backend, "device": str(mesh.device),
                  "shape": list(mesh.shape),
                  "current_device": torch.cuda.current_device(),
                  "name": torch.cuda.get_device_name(mesh.device),
                  "uuid": str(torch.cuda.get_device_properties(
                      mesh.device).uuid)}


def counted_call(fn):
    """``fn()`` and what it added: launches, collectives by kind, halo
    bytes and host seconds."""
    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.parallel import spatial as sp

    cs.reset_launches()
    before, halo = dict(pm.COLLECTIVES), dict(sp.HALO)
    out = fn()
    return out, {"launches": cs.read_launches(),
                 "collectives": {k: n - before.get(k, 0)
                                 for k, n in pm.COLLECTIVES.items()
                                 if n != before.get(k, 0)},
                 "halo_bytes": sp.HALO["bytes"] - halo.get("bytes", 0),
                 "halo_s": sp.HALO["seconds"] - halo.get("seconds", 0.0)}


def replicated(mesh, model) -> bool:
    from radar_depth_tpu_torch.parallel import mesh as pm

    try:
        return pm.assert_replicated(model, mesh)
    except RuntimeError:
        return False


def step_runs(torch, np, mesh, cfg, sd, rows, seeds, refs, ref_sums,
              trace_want=None):
    """The train step over ``mesh`` from ``sd``, graphed and then eager
    (each from a fresh model): step i from ``refs[i-1]`` (the one-process
    trajectory's parameters), its generator seeded ``seeds[i]``. Per mode
    and step: sums, launches, collectives, halos, replicas; the graphed
    steps compared on rank 0 against the one-process ones; the end states
    compared across modes; a traced replay of the graph."""
    from radar_depth_tpu_torch import graphs
    from radar_depth_tpu_torch.train.step import make_train_step

    dev = mesh.device
    out, ends = {}, {}
    for mode in (GRAPH, EAGER):
        with cs.graph_or_eager(mode):
            model, spec, state, _ = cs.train_setup(torch, cfg, dev,
                                                   state_dict=sd)
            step = make_train_step(model, spec, cfg, mesh=mesh)
            gen = torch.Generator(device=dev)
            run = {"sums": [], "counts": [], "replicated": [], "cmp": []}
            for i, seed in enumerate(seeds):
                if i:  # in place: the graph's addresses stay
                    model.load_state_dict(refs[i - 1])
                gen.manual_seed(seed)
                sums, counts = counted_call(lambda: floats(step(
                    state, rows, generator=gen)))
                run["sums"].append(sums)
                run["counts"].append(counts)
                run["replicated"].append(replicated(mesh, model))
                if mode == GRAPH and mesh.is_main:
                    try:
                        run["cmp"].append(compare_step(
                            np, model, sums, sd if i == 0
                            else refs[i - 1], refs[i], ref_sums[i],
                            f"step {i}"))
                    except AssertionError as e:
                        run["cmp"].append({"error": str(e)[:400]})
            run["stats"] = (dict(step.graphs.stats) if step.graphs
                            else None)
            ends[mode] = (cpu_state(model), momentum(state))
            if mode == GRAPH and trace_want is not None:
                try:
                    run["trace"] = cs.replay_trace(
                        torch, step.graphs,
                        lambda: step(state, rows, generator=gen),
                        trace_want)
                except AssertionError as e:
                    run["trace"] = {"error": str(e)[:600]}
            out[mode] = run
        del model, state, step
        free_card(torch)
    g, e = ends[GRAPH], ends[EAGER]
    out["graph_equals_eager"] = (
        out[GRAPH]["sums"] == out[EAGER]["sums"]
        and states_equal(torch, g[0], e[0])
        and all(torch.equal(a, b) for a, b in zip(g[1], e[1])))
    return out


def dp_rate(torch, mesh, cfg, sd, rows, mode):
    """bfloat16 steps on the resident ``rows``: RATE_WARM, then
    RATE_TIMED timed as one window; img/s of this rank, peak GiB."""
    from radar_depth_tpu_torch.ops.preprocess import to_device
    from radar_depth_tpu_torch.train.step import make_train_step

    dev = mesh.device
    with cs.graph_or_eager(mode):
        model, spec, state, _ = cs.train_setup(torch, cfg, dev,
                                               state_dict=sd)
        step = make_train_step(model, spec, cfg, mesh=mesh)
        batch = to_device(rows, dev)
        gen = torch.Generator(device=dev).manual_seed(20)
        free_card(torch)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(RATE_WARM):
            step(state, batch, generator=gen)
        torch.cuda.synchronize(dev)
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(RATE_TIMED):
            last = step(state, batch, generator=gen)
        loss = float(last["loss"])
        wall = time.perf_counter() - t0
        out = {"rows": int(batch["image"].shape[0]), "steps": RATE_TIMED,
               "wall_s": wall, "loss": loss,
               "img_per_s_rank": batch["image"].shape[0] * RATE_TIMED / wall,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
               "stats": dict(step.graphs.stats) if step.graphs else None}
    del model, state, step, batch
    free_card(torch)
    return out


def worker_dp(root) -> int:
    """Phases (a), (b), (c) on one rank of the data mesh."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from radar_depth_tpu_torch.parallel import mesh as pm
    from radar_depth_tpu_torch.train.step import (
        make_eval_step,
        make_train_step,
    )

    mesh, place = worker_mesh(torch)
    dev = mesh.device
    sd = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    batch = dict(np.load(os.path.join(root, "batch.npz")))
    ref = torch.load(os.path.join(root, "refs.pt"), weights_only=True)
    b8 = {k: v[:B_DP] for k, v in batch.items()}
    rows = pm.local_rows(b8, mesh)
    out = {"place": place, "rows": int(rows["image"].shape[0])}
    cfg32 = cs.train_config("float32")
    with cs.deterministic_cudnn(torch):
        # (a) float32 steps, graphed and eager
        out["a"] = step_runs(
            torch, np, mesh, cfg32, sd, rows,
            [10 + i for i in range(DP_STEPS)], ref["dp_states"],
            ref["dp_sums"], want_train_launches())
        # (a) bfloat16 rate at B_RANK_BF16 rows a rank
        cfg16 = cs.train_config("bfloat16")
        rows16 = {k: v[:B_RANK_BF16] for k, v in batch.items()}
        out["rate"] = {mode: dp_rate(torch, mesh, cfg16, sd, rows16, mode)
                       for mode in (GRAPH, EAGER)}
        # the flat gradient all-reduce (all_reduce_sum: one buffer), and a
        # bare all-reduce of as many bytes
        model = cs.train_setup(torch, cfg32, dev, state_dict=sd)[0]
        grads = [torch.ones_like(p) for p in model.parameters()]
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        flat = torch.ones(nbytes // 4, device=dev)
        out["grad_all_reduce"] = {
            "tensors": len(grads), "bytes": nbytes,
            "ms": cs.cuda_ms(torch, lambda: pm.all_reduce_sum(grads, mesh)),
            "ms_bare_all_reduce": cs.cuda_ms(
                torch, lambda: dist.all_reduce(flat))}
        del model, grads, flat
        free_card(torch)

        # (b) grad_accum 2 over the mesh
        cfg_acc = dataclasses.replace(cfg32, optim=dataclasses.replace(
            cfg32.optim, grad_accum=2))
        stacked = {k: v[:2 * B_DP].reshape((2, B_DP) + v.shape[1:])
                   for k, v in batch.items()}
        rows_acc = pm.local_rows(stacked, mesh, accum=True)
        model, spec, state, _ = cs.train_setup(torch, cfg_acc, dev,
                                               state_dict=sd)
        step = make_train_step(model, spec, cfg_acc, mesh=mesh)
        gen = torch.Generator(device=dev)
        b = {"rows": int(rows_acc["image"].shape[1]), "steps": []}
        for i in range(3):
            gen.manual_seed(30 + i)
            sums, counts = counted_call(lambda: floats(step(
                state, rows_acc, generator=gen)))
            b["steps"].append(dict(counts, sums=sums,
                                   replicated=replicated(mesh, model)))
            if i == 0 and mesh.is_main:
                try:
                    b["cmp"] = compare_step(np, model, sums, sd,
                                            ref["acc_state"], ref["acc_sums"],
                                            "grad_accum step")
                except AssertionError as e:
                    b["cmp"] = {"error": str(e)[:400]}
        b["stats"] = dict(step.graphs.stats) if step.graphs else None
        out["b"] = b
        del model, state, step
        free_card(torch)

        # (c) the eval step: three calls graphed, one eager
        model, spec = cs.train_setup(torch, cfg32, dev, state_dict=sd)[:2]
        ev = make_eval_step(model, spec, cfg32, mesh=mesh)
        calls = []
        for mode in (GRAPH,) * 3 + (EAGER,):
            with cs.graph_or_eager(mode):
                sums, counts = counted_call(lambda: floats(ev(rows)))
            calls.append(dict(counts, sums=sums))
        out["c"] = {"calls": calls,
                    "stats": dict(ev.graphs.stats) if ev.graphs else None}
        del model, ev
    write_rank(root, mesh.rank, out)
    mesh.barrier()
    pm.destroy_mesh(mesh)
    return 0


def predictor_calls(np, pred, batch):
    """Three ``predict`` calls graphed and one eager: each call's counts,
    the maps' digests, the first map, the graph's stats."""
    maps, counts = [], []
    for mode in (GRAPH,) * 3 + (EAGER,):
        with cs.graph_or_eager(mode):
            m, c = counted_call(lambda: pred.predict(batch))
        maps.append(m)
        counts.append(c)
    return {"counts": counts, "digests": [digest(m) for m in maps],
            "shape": list(maps[0].shape),
            "finite": bool(np.isfinite(maps[0]).all()),
            "stats": dict(pred.graphs.stats) if pred.graphs else None,
            "calls_bit_equal": all(np.array_equal(m, maps[-1])
                                   for m in maps)}, maps[0]


def pdl_replays(torch, pred, batch, n):
    """The forward's replay ``n`` times on a resident batch, each map held
    on the card to the first replay's: mismatched elements in all."""
    from radar_depth_tpu_torch.ops.preprocess import to_device

    resident = to_device(batch, pred.device)
    pred.infer(resident)  # eager
    first = pred.infer(resident).clone()  # captured
    bad = torch.zeros((), dtype=torch.int64, device=pred.device)
    t0 = time.perf_counter()
    for _ in range(n):
        bad += (pred.infer(resident) != first).sum()
    mismatched = int(bad)
    return {"replays": n, "mismatched_elements": mismatched,
            "seconds": time.perf_counter() - t0,
            "stats": dict(pred.graphs.stats) if pred.graphs else None}


def worker_spatial(root) -> int:
    """Phases (d) and (e) on one rank: meshes (2, 2), (4,) and (1, 4)."""
    import numpy as np
    import torch

    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor
    from radar_depth_tpu_torch.parallel import mesh as pm

    data4, place = worker_mesh(torch)
    sp22 = pm.make_spatial_mesh(2)
    sp4 = pm.make_spatial_mesh(4)
    dev = data4.device
    sd = torch.load(os.path.join(root, "weights.pt"), weights_only=True)
    b8 = dict(np.load(os.path.join(root, "batch.npz")))
    big = dict(np.load(os.path.join(root, "big.npz")))
    ref = torch.load(os.path.join(root, "refs.pt"), weights_only=True)
    out = {"place": place, "shapes": {"sp22": list(sp22.shape),
                                      "sp4": list(sp4.shape)}}
    cfg32 = cs.train_config("float32")
    cfg_big = cs.train_config("float32", height=BIG_H, width=BIG_W)

    def save_map(name, m):
        if data4.is_main:
            np.save(os.path.join(root, f"map-{name}.npy"), m)

    with cs.deterministic_cudnn(torch):
        # (d) and (e): the float32 Predictor over each mesh
        out["predict"] = {}
        for name, mesh, cfg, batch in (("sp22", sp22, cfg32, b8),
                                       ("data4", data4, cfg32, b8),
                                       ("sp4", sp4, cfg_big, big)):
            pred = Predictor(serve_config(cfg), sd, mesh=mesh)
            out["predict"][name], first = predictor_calls(np, pred,
                                                          batch)
            save_map(name, first)
            pred.close()  # its graphs hold the mesh's communicators
            del pred, first
            free_card(torch)

        # (d) the train step over (2, 2), graphed and eager
        rows = pm.local_rows(b8, sp22)
        out["train"] = step_runs(
            torch, np, sp22, cfg32, sd, rows,
            [10 + i for i in range(SP_STEPS)], ref["sp_states"],
            ref["sp_sums"], want_train_launches())
        out["train"]["rows"] = int(rows["image"].shape[0])

        # (d) the PDL check: the bfloat16 forward's replays
        pred = Predictor(serve_config(cs.train_config("bfloat16")), sd,
                         mesh=sp22)
        out["pdl"] = pdl_replays(torch, pred, b8, PDL_REPLAYS)
        pred.close()
        del pred
        free_card(torch)

        # (d) bfloat16 B=8 train rate over (2, 2)
        out["bf16"] = cs.spatial_bf16_steps(torch, dev, sd, rows, sp22)
    write_rank(root, data4.rank, out)
    data4.barrier()
    pm.destroy_mesh(data4)
    return 0


def trainer_worker(out_dir, argv) -> int:
    """One rank under torchrun: ``train.main.run(argv)``, then this rank's
    Trainer's graph stats and epochs into ``out_dir``/rank{r}.json."""
    from radar_depth_tpu_torch.train import loop
    from radar_depth_tpu_torch.train import main as train_main

    seen = []
    fit = loop.Trainer.fit

    def kept(self):
        seen.append(self)
        return fit(self)

    loop.Trainer.fit = kept
    res = train_main.run(argv)
    tr = seen[0]
    rank = int(os.environ.get("RANK", 0))
    write_rank(out_dir, rank, {
        "rank": rank, "device": str(tr.device),
        "mesh": list(tr.mesh.shape), "axes": list(tr.mesh.axis_names),
        "reader": res["reader"], "host_augment": res["host_augment"],
        "train_graphs": (dict(tr._train_step.graphs.stats)
                         if tr._train_step.graphs else None),
        "eval_graphs": (dict(tr._eval_step.graphs.stats)
                        if tr._eval_step.graphs else None),
        "epochs": [{"epoch": h["epoch"], "walls": h["walls"],
                    **{f"train_{k}": h["train"][k] for k in
                       ("data_time", "gpu_time", "steps", "loss")},
                    "val_gpu_time": h["val"]["gpu_time"]}
                   for h in res["history"]]})
    return 0


# ------------------------------------------------- the parent's phases


def ref_trajectory(torch, dev, cfg, sd, batch, seeds):
    """The one-process train step from ``sd``: per step (seeded
    ``seeds[i]``) its sums and the state after it."""
    from radar_depth_tpu_torch.train.step import make_train_step

    model, spec, state, _ = cs.train_setup(torch, cfg, dev, state_dict=sd)
    step = make_train_step(model, spec, cfg)
    gen = torch.Generator(device=dev)
    sums, states = [], []
    for seed in seeds:
        gen.manual_seed(seed)
        sums.append(floats(step(state, batch, generator=gen)))
        states.append(cpu_state(model))
    del model, state, step
    return sums, states


def check_placement(gates, lines, what):
    for r, line in lines.items():
        p = line["place"]
        gates.check(p["device"] == f"cuda:{r}" and p["world"] == WORLD
                    and p["backend"] == "nccl" and p["current_device"] == r,
                    f"{what} rank {r} placement", p)
    uuids = [line["place"]["uuid"] for line in lines.values()]
    gates.check(len(set(uuids)) == WORLD, f"{what}: four cards", uuids)


def check_step_runs(gates, lines, what, steps):
    """The gates of ``step_runs`` over every rank's line."""
    out = {}
    r0 = lines[0]
    for r, line in lines.items():
        g, e = line[GRAPH], line[EAGER]
        gates.check(line["graph_equals_eager"],
                    f"{what} rank {r}: graph differs from eager")
        gates.check(all(g["replicated"]) and all(e["replicated"]),
                    f"{what} rank {r}: replicas differ",
                    [g["replicated"], e["replicated"]])
        gates.check(g["sums"] == r0[GRAPH]["sums"],
                    f"{what} rank {r}: sums differ from rank 0's")
        cg = [c["collectives"] for c in g["counts"]]
        ce = [c["collectives"] for c in e["counts"]]
        gates.check(cg == ce and all(c == cg[0] for c in cg),
                    f"{what} rank {r}: collectives a step", [cg, ce])
        hb = [[c["halo_bytes"] for c in m["counts"]] for m in (g, e)]
        gates.check(hb[0] == hb[1], f"{what} rank {r}: halo bytes", hb)
        gates.check(g["stats"] == graph_stats(steps),
                    f"{what} rank {r}: graph stats", g["stats"])
        gates.check(all(c["launches"] == want_train_launches()
                        for m in (g, e) for c in m["counts"]),
                    f"{what} rank {r}: launches a step",
                    g["counts"][-1]["launches"])
        tr = g.get("trace", {})
        gates.check("error" not in tr and tr.get("nccl_device_events", 0) > 0,
                    f"{what} rank {r}: traced replay", tr)
        if cg[0].get("halo"):
            gates.check(all(c["halo_s"] == 0 for c in g["counts"][1:])
                        and all(c["halo_s"] > 0 for c in e["counts"]),
                        f"{what} rank {r}: halo host seconds",
                        [[c["halo_s"] for c in m["counts"]] for m in (g, e)])
    cmp = r0[GRAPH]["cmp"]
    gates.check(len(cmp) == steps and not any("error" in c for c in cmp),
                f"{what}: steps against one process", cmp)
    out.update({
        "vs_one_process": cmp,
        "losses": [s["loss"] for s in r0[GRAPH]["sums"]],
        "graph_bit_equal_to_eager": all(line["graph_equals_eager"]
                                        for line in lines.values()),
        "replicas_bit_equal_every_step": True,
        "graph_stats": r0[GRAPH]["stats"],
        "collectives_per_step": r0[GRAPH]["counts"][-1]["collectives"],
        "collectives_per_step_eager": r0[EAGER]["counts"][-1]["collectives"],
        "halo_bytes_per_step": r0[GRAPH]["counts"][-1]["halo_bytes"],
        "halo_host_ms_per_eager_step": [c["halo_s"] * 1e3 for c in
                                        r0[EAGER]["counts"]],
        "launches_per_rank_step": [lines[r][GRAPH]["counts"][-1]["launches"]
                                   for r in sorted(lines)],
        "traced_replay": {r: {k: lines[r][GRAPH].get("trace", {}).get(k)
                              for k in ("traced", "device_kernels",
                                        "nccl_device_events")}
                          for r in sorted(lines)}})
    return out


def phase_dp(torch, np, dev, batch, sd, root, emit_line):
    """Phases (a), (b), (c): references here, then the four ranks."""
    from radar_depth_tpu_torch.train.step import make_eval_step

    os.makedirs(root, exist_ok=True)
    cfg32 = cs.train_config("float32")
    b8 = {k: v[:B_DP] for k, v in batch.items()}
    cfg_acc = dataclasses.replace(cfg32, optim=dataclasses.replace(
        cfg32.optim, grad_accum=2))
    stacked = {k: v[:2 * B_DP].reshape((2, B_DP) + v.shape[1:])
               for k, v in batch.items()}
    t0 = time.perf_counter()
    with cs.deterministic_cudnn(torch):
        dp_sums, dp_states = ref_trajectory(
            torch, dev, cfg32, sd, b8, [10 + i for i in range(DP_STEPS)])
        acc_sums, acc_states = ref_trajectory(torch, dev, cfg_acc, sd,
                                              stacked, [30])
        model, spec = cs.train_setup(torch, cfg32, dev, state_dict=sd)[:2]
        ev_sums = floats(make_eval_step(model, spec, cfg32)(b8))
        del model
    torch.save({"dp_sums": dp_sums, "dp_states": dp_states,
                "acc_sums": acc_sums[0], "acc_state": acc_states[0]},
               os.path.join(root, "refs.pt"))
    torch.save(sd, os.path.join(root, "weights.pt"))
    np.savez(os.path.join(root, "batch.npz"), **batch)
    del dp_states, acc_states
    free_card(torch)
    ref_s = time.perf_counter() - t0

    gates = Gates()
    lines, seconds = launch_ranks(gates, "dp", root)
    results = {}
    if sorted(lines) == list(range(WORLD)):
        check_placement(gates, lines, "dp")
        a = check_step_runs(gates, {r: x["a"] for r, x in lines.items()},
                            "dp", DP_STEPS)
        rate = {m: [lines[r]["rate"][m] for r in range(WORLD)]
                for m in (GRAPH, EAGER)}
        glob = {m: sum(x["rows"] for x in rate[m]) * RATE_TIMED
                / max(x["wall_s"] for x in rate[m]) for m in rate}
        results["a"] = dict(a, rows_per_rank=lines[0]["rows"],
                            bf16_rate=rate, grad_all_reduce=[
                                lines[r]["grad_all_reduce"]
                                for r in range(WORLD)],
                            img_per_s_4_ranks=glob)
    # one card's plain bfloat16 step at B_RANK_BF16, on card 0 (free now)
    with cs.deterministic_cudnn(torch):
        one = one_card_rate(torch, dev, sd, batch)
    if "a" in results:
        a = results["a"]
        a["one_card_plain"] = one
        a["img_per_s_4_ranks_over_4_cards"] = {
            m: r / (WORLD * one["img_per_s"])
            for m, r in a["img_per_s_4_ranks"].items()}
    emit_line("dp", dict(results.get("a", {}), reference_s=ref_s,
                         ranks_s=seconds), gates)

    # (b)
    gates_b = Gates()
    if sorted(lines) == list(range(WORLD)):
        bs = {r: lines[r]["b"] for r in lines}
        for r, b in bs.items():
            gates_b.check(all(s["replicated"] for s in b["steps"]),
                          f"grad_accum rank {r}: replicas differ")
            gates_b.check(b["steps"][0]["sums"] == bs[0]["steps"][0]["sums"],
                          f"grad_accum rank {r}: sums differ from rank 0's")
            gates_b.check(b["stats"] == graph_stats(3),
                          f"grad_accum rank {r}: graph stats", b["stats"])
            gates_b.check(all(s["launches"] == want_train_launches(2)
                              for s in b["steps"]),
                          f"grad_accum rank {r}: launches",
                          b["steps"][-1]["launches"])
        gates_b.check("cmp" in bs[0] and "error" not in bs[0]["cmp"],
                      "grad_accum: step against one process",
                      bs[0].get("cmp"))
        emit_line("grad_accum", {
            "rows_per_rank_micro": bs[0]["rows"], "vs_one_process":
            bs[0].get("cmp"), "losses": [s["sums"]["loss"]
                                         for s in bs[0]["steps"]],
            "graph_stats": bs[0]["stats"],
            "launches_per_rank_step": [bs[r]["steps"][-1]["launches"]
                                       for r in sorted(bs)],
            "collectives_per_step": bs[0]["steps"][-1]["collectives"]},
            gates_b)
    else:
        emit_line("grad_accum", {}, gates_b.check(False, "no ranks")
                  or gates_b)

    # (c)
    gates_c = Gates()
    if sorted(lines) == list(range(WORLD)):
        cs_ = {r: lines[r]["c"] for r in lines}
        err = 0.0
        for r, c in cs_.items():
            sums = [x["sums"] for x in c["calls"]]
            gates_c.check(all(s == sums[-1] for s in sums),
                          f"dp_eval rank {r}: replays differ from eager")
            gates_c.check(sums[-1] == cs_[0]["calls"][-1]["sums"],
                          f"dp_eval rank {r}: sums differ from rank 0's")
            err = max([err] + [abs(sums[0][k] - v) / max(abs(v), 1e-30)
                               for k, v in ev_sums.items()])
            coll = [x["collectives"] for x in c["calls"]]
            gates_c.check(all(x == coll[-1] for x in coll),
                          f"dp_eval rank {r}: collectives a call", coll)
            gates_c.check(c["stats"] == graph_stats(3, 1),
                          f"dp_eval rank {r}: graph stats", c["stats"])
            gates_c.check(all(x["launches"] == want_eval_launches()
                              for x in c["calls"]),
                          f"dp_eval rank {r}: launches",
                          c["calls"][-1]["launches"])
        gates_c.check(err <= cs.SUMS_RTOL, "dp_eval: sums vs one process",
                      err)
        emit_line("dp_eval", {
            "sums_max_rel_vs_one_process": err,
            "graph_stats": cs_[0]["stats"],
            "launches_per_rank_call": [cs_[r]["calls"][-1]["launches"]
                                       for r in sorted(cs_)],
            "collectives_per_call": cs_[0]["calls"][-1]["collectives"]},
            gates_c)
    else:
        emit_line("dp_eval", {}, gates_c.check(False, "no ranks") or gates_c)


def one_card_rate(torch, dev, sd, batch):
    """One card's plain bfloat16 step (no mesh) at B_RANK_BF16 rows on a
    resident batch: the same window as the ranks' ``dp_rate``."""
    from radar_depth_tpu_torch.parallel.mesh import DataMesh

    mesh = DataMesh(device=dev)  # no group: the single-process step
    mesh.barrier()
    out = dp_rate(torch, mesh, cs.train_config("bfloat16"), sd,
                  {k: v[:B_RANK_BF16] for k, v in batch.items()}, GRAPH)
    out["img_per_s"] = out["img_per_s_rank"]
    return out


def phase_spatial(torch, np, dev, batch, big, sd, root, emit_line):
    """Phases (d) and (e): references here, then the four ranks."""
    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor

    os.makedirs(root, exist_ok=True)
    cfg32 = cs.train_config("float32")
    cfg_big = cs.train_config("float32", height=BIG_H, width=BIG_W)
    b8 = {k: v[:B_DP] for k, v in batch.items()}
    t0 = time.perf_counter()
    with cs.deterministic_cudnn(torch):
        ref_plain = Predictor(serve_config(cfg32), sd, device=dev,
                              plain=True).predict(b8)
        ref_k = Predictor(serve_config(cfg32), sd, device=dev).predict(b8)
        free_card(torch)
        ref_big = Predictor(serve_config(cfg_big), sd, device=dev
                            ).predict(big)
        free_card(torch)
        sp_sums, sp_states = ref_trajectory(
            torch, dev, cfg32, sd, b8, [10 + i for i in range(SP_STEPS)])
        free_card(torch)
        plain_bf16 = cs.spatial_bf16_steps(torch, dev, sd, b8, None)
    torch.save({"sp_sums": sp_sums, "sp_states": sp_states},
               os.path.join(root, "refs.pt"))
    torch.save(sd, os.path.join(root, "weights.pt"))
    np.savez(os.path.join(root, "batch.npz"), **b8)
    np.savez(os.path.join(root, "big.npz"), **big)
    del sp_states
    free_card(torch)
    ref_s = time.perf_counter() - t0

    gates = Gates()
    lines, seconds = launch_ranks(gates, "spatial", root)
    have = sorted(lines) == list(range(WORLD))
    maps = {n: np.load(os.path.join(root, f"map-{n}.npy"))
            for n in ("sp22", "data4", "sp4") if have}
    refs = {"sp22": ref_k, "data4": ref_k, "sp4": ref_big}
    pred_out = {}
    if have:
        check_placement(gates, lines, "spatial")
        pred_out["sp22"] = check_predictor(np, gates, lines, "sp22",
                                           maps["sp22"], refs["sp22"])
        pred_out["sp22"]["rel_rmse_vs_plain"] = cs.rel_rmse(
            np, maps["sp22"], ref_plain)
        gates.check(pred_out["sp22"]["rel_rmse_vs_plain"]
                    <= cs.PARITY_REL_RMSE_TOL,
                    "spatial: forward vs the plain Predictor",
                    pred_out["sp22"]["rel_rmse_vs_plain"])
        train = check_step_runs(gates, {r: x["train"]
                                        for r, x in lines.items()},
                                "spatial", SP_STEPS)
        pdl = {r: lines[r]["pdl"] for r in lines}
        for r, p in pdl.items():
            gates.check(p["mismatched_elements"] == 0,
                        f"spatial rank {r}: PDL replays differ", p)
        bf16 = [lines[r]["bf16"] for r in range(WORLD)]
        rate = bf16[0]["img_per_s"]
        emit_line("spatial", {
            "mesh": lines[0]["shapes"]["sp22"],
            "forward": pred_out["sp22"], "train": train,
            "rows_per_rank": lines[0]["train"]["rows"],
            "pdl_replays": pdl,
            "bf16": {"per_rank": bf16, "img_per_s_global": rate,
                     "img_per_s_per_data_index": rate / 2,
                     "one_card_plain": plain_bf16,
                     "over_one_card": rate / plain_bf16["img_per_s"],
                     "peak_gib_per_rank": [x["peak_gib"] for x in bf16]},
            "reference_s": ref_s, "ranks_s": seconds}, gates)
    else:
        emit_line("spatial", {"reference_s": ref_s, "ranks_s": seconds},
                  gates)
    gates_e = Gates()
    if have:
        for name in ("data4", "sp4"):
            pred_out[name] = check_predictor(
                np, gates_e, lines, name, maps[name], refs[name])
        emit_line("predictor_mesh", {
            "meshes": {"data4": [WORLD], "sp22": [2, 2], "sp4": [1, WORLD]},
            "big_hw": [BIG_H, BIG_W], "big_batch": B_BIG,
            **{n: pred_out[n] for n in ("data4", "sp22", "sp4")}}, gates_e)
    else:
        gates_e.check(False, "no ranks")
        emit_line("predictor_mesh", {}, gates_e)


def check_predictor(np, gates, lines, name, got, want):
    """The gates of ``predictor_calls`` for the mesh ``name``."""
    recs = {r: lines[r]["predict"][name] for r in lines}
    err = cs.rel_rmse(np, got, want)
    d0 = recs[0]["digests"]
    for r, rec in recs.items():
        gates.check(rec["calls_bit_equal"] and rec["digests"] == d0,
                    f"{name} rank {r}: maps differ (calls or ranks)",
                    rec["digests"])
        gates.check(rec["finite"] and tuple(rec["shape"]) == want.shape,
                    f"{name} rank {r}: map shape", rec["shape"])
        coll = [c["collectives"] for c in rec["counts"]]
        gates.check(all(c == coll[-1] for c in coll),
                    f"{name} rank {r}: collectives a call", coll)
        gates.check(rec["stats"] == graph_stats(3, 1),
                    f"{name} rank {r}: graph stats", rec["stats"])
        gates.check(all(c["launches"] == want_eval_launches()
                        for c in rec["counts"]),
                    f"{name} rank {r}: launches",
                    rec["counts"][-1]["launches"])
    gates.check(err <= cs.PARITY_REL_RMSE_TOL,
                f"{name}: map vs one process", err)
    last = recs[0]["counts"][-1]
    return {"rel_rmse_vs_one_process": err,
            "max_abs_vs_one_process": float(np.abs(got - want).max()),
            "graph_stats": recs[0]["stats"],
            "maps_bit_equal_to_eager_and_across_ranks": True,
            "launches_per_rank_call": [recs[r]["counts"][-1]["launches"]
                                       for r in sorted(recs)],
            "collectives_per_call": last["collectives"],
            "halo_bytes_per_call": last["halo_bytes"]}


# --------------------------------------------------------- the daemon


def write_run(run_dir, cfg, sd):
    """config.json and one checkpoint of ``sd``, through the port's own
    writers (a run that Predictor.from_run serves)."""
    import torch

    from radar_depth_tpu_torch.config import save_config
    from radar_depth_tpu_torch.models import create_model
    from radar_depth_tpu_torch.train.checkpoint import CheckpointManager
    from radar_depth_tpu_torch.train.state import create_train_state

    cfg = dataclasses.replace(cfg, output_dir=run_dir)
    os.makedirs(run_dir, exist_ok=True)
    save_config(cfg, os.path.join(run_dir, "config.json"))
    model = create_model(cfg.model.arch, device="cpu",
                         decoder=cfg.model.decoder,
                         output_size=(cfg.data.height, cfg.data.width),
                         param_dtype=torch.float32)[0]
    model.load_state_dict(sd)
    ckpt = CheckpointManager(run_dir)
    ckpt.save(0, create_train_state(model, cfg.optim, 1), {"rmse": 1.0},
              wait=True)
    ckpt.close()
    return cfg


def run_clients(np, url, bodies, per_client, shape):
    """SERVE_CLIENTS clients, client i sending ``bodies[i]`` (one sample)
    ``per_client`` times in turn: req/s, p50/p99 ms; each answer a finite
    map of ``shape``."""
    import threading

    lat, bad, lock = [], [], threading.Lock()
    deadline = time.monotonic() + CLIENTS_S

    def client(ci):
        for _ in range(per_client):
            if bad or time.monotonic() > deadline:
                return
            t0 = time.perf_counter()
            status, body = cs.http(f"{url}/predict", bodies[ci])
            dt = time.perf_counter() - t0
            ok = status == 200
            if ok:
                d = cs.npz_depth(np, body)
                ok = d.shape == shape and bool(np.isfinite(d).all())
            with lock:
                lat.append(dt)
                if not ok:
                    bad.append(status)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(1.0, deadline + REQUEST_S - time.monotonic()))
    wall = time.perf_counter() - t0
    lat_ms = np.asarray(lat) * 1e3
    return {"clients": SERVE_CLIENTS, "requests": len(lat), "wall_s": wall,
            "req_per_s": len(lat) / wall, "failures": bad,
            "hung": any(t.is_alive() for t in threads),
            "p50_ms": float(np.percentile(lat_ms, 50)) if lat else None,
            "p99_ms": float(np.percentile(lat_ms, 99)) if lat else None}


def serve_ranks(np, gates, run_dir, space, samples, refs, root):
    """The daemon over WORLD ranks with ``--spatial space`` on the run
    ``run_dir``: each rank ``python -m radar_depth_tpu_torch.serve`` with
    torchrun's variables, the leader on 127.0.0.1."""
    port, master = cs.free_ports(2)
    url = f"http://127.0.0.1:{port}"
    cmd = [sys.executable, "-m", "radar_depth_tpu_torch.serve", "--run",
           run_dir, "--spatial", str(space), "--port", str(port),
           "--max-tile", str(SERVE_TILE), "--batch-window-ms",
           str(cs.HTTP_WINDOW_MS)]
    logs = [(open(os.path.join(root, f"serve{space}-{r}.out"), "w+"),
             open(os.path.join(root, f"serve{space}-{r}.err"), "w+"))
            for r in range(WORLD)]
    take = lambda lo, hi: {k: v[lo:hi] for k, v in samples.items()}
    h, w = samples["image"].shape[1:3]
    out = {"space": space, "mesh": [WORLD // space, space], "hw": [h, w],
           "dtype": "float32", "max_tile": SERVE_TILE,
           "window_ms": cs.HTTP_WINDOW_MS}

    def tails():
        text = []
        for r, (o, e) in enumerate(logs):
            for f in (o, e):
                f.flush()
                f.seek(0)
            text.append(f"rank {r}:\n{o.read()[-1500:]}\n{e.read()[-3000:]}")
        return "\n".join(text)

    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=HERE, env=rank_env(r, master),
                              stdout=logs[r][0], stderr=logs[r][1],
                              start_new_session=True)
             for r in range(WORLD)]
    try:
        codes = []
        deadline = time.monotonic() + RANK_TIMEOUT_S["daemon"]
        while not codes or codes[-1] != 200:
            if time.monotonic() > deadline or any(p.poll() is not None
                                                  for p in procs):
                raise AssertionError(f"healthz {codes[-3:]}:\n{tails()}")
            try:
                codes.append(cs.http(f"{url}/healthz")[0])
            except OSError:
                pass
            time.sleep(0.1)
        out["ready_s"] = time.perf_counter() - t0
        gates.check(503 in codes, f"daemon {space}: no 503 before 200",
                    codes[:5])

        errs = {}
        for n, (lo, hi) in (("b1", (0, 1)), ("b3", (1, 4)), ("b8", (0, 8))):
            t1 = time.perf_counter()
            status, body = cs.http(f"{url}/predict",
                                   cs.npz_body(np, take(lo, hi)))
            ms = (time.perf_counter() - t1) * 1e3
            if gates.check(status == 200, f"daemon {space}: {n} status",
                           body[:200]):
                d = cs.npz_depth(np, body)
                errs[n] = {"rel_rmse": cs.rel_rmse(np, d, refs[n]),
                           "max_abs": float(np.abs(d - refs[n]).max()),
                           "ms": ms}
                gates.check(d.shape == refs[n].shape
                            and errs[n]["rel_rmse"]
                            <= cs.PARITY_REL_RMSE_TOL,
                            f"daemon {space}: {n} vs one process", errs[n])
        out["vs_one_process"] = errs

        bodies = [cs.npz_body(np, take(i, i + 1))
                  for i in range(SERVE_CLIENTS)]
        conc = run_clients(np, url, bodies, SERVE_PER_CLIENT, (1, h, w))
        gates.check(not conc["failures"] and not conc["hung"]
                    and conc["requests"] == SERVE_CLIENTS * SERVE_PER_CLIENT,
                    f"daemon {space}: clients", conc)
        out["concurrency"] = conc

        bad = take(0, 1)
        del bad["intrinsics"]
        status, resp = cs.http(f"{url}/predict", cs.npz_body(np, bad))
        out["bad_request_status"] = status
        gates.check(status == 400 and b"batch keys" in resp,
                    f"daemon {space}: bad body", resp[:200])
        status, _ = cs.http(f"{url}/predict", cs.npz_body(np, take(0, 1)))
        gates.check(status == 200, f"daemon {space}: served after a 400",
                    status)

        t1 = time.perf_counter()
        os.kill(procs[0].pid, signal.SIGINT)
        for p in procs:
            p.wait(timeout=max(1.0, cs.SERVE_SPATIAL_EXIT_S
                               - (time.perf_counter() - t1)))
        out["stop_s"] = time.perf_counter() - t1
        rcs = [p.returncode for p in procs]
        gates.check(rcs == [0] * WORLD, f"daemon {space}: exit codes",
                    f"{rcs}\n{tails()}")
        lines = []
        for o, _ in logs:
            o.flush()
            o.seek(0)
            lines.append(json.loads(o.read().strip().splitlines()[-1]))
    except (AssertionError, subprocess.TimeoutExpired, ValueError,
            IndexError) as e:
        gates.check(False, f"daemon {space}", f"{e}\n{tails()}"[:3000])
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        for o, e in logs:
            o.close()
            e.close()
    leader = lines[0]
    gates.check(leader["role"] == "leader"
                and all(x["role"] == "follower" for x in lines[1:])
                and all(x["dispatches"] == leader["dispatches"]
                        and x["predict_calls"] == leader["predict_calls"]
                        for x in lines),
                f"daemon {space}: ranks' counts", lines)
    bc = leader.get("broadcast", {"messages": 0, "bytes": 0, "seconds": 0})
    out.update({"ranks": lines, "dispatches": leader["dispatches"],
                "predict_calls": leader["predict_calls"],
                "broadcast_messages": bc["messages"],
                "broadcast_ms_per_message":
                    bc["seconds"] * 1e3 / max(bc["messages"], 1),
                "broadcast_mb_per_message":
                    bc["bytes"] / max(bc["messages"], 1) / 1e6})
    return out


def phase_daemon(torch, np, dev, batch, big, sd, root, emit_line):
    """(f): the daemon over four ranks, --spatial 2 at 450x800, then
    --spatial 4 on a 900x1600 run."""
    from radar_depth_tpu_torch.config import serve_config
    from radar_depth_tpu_torch.inference import Predictor

    os.makedirs(root, exist_ok=True)
    gates = Gates()
    out = {}
    for space, cfg, samples in (
            (2, cs.train_config("float32"), batch),
            (WORLD, cs.train_config("float32", height=BIG_H, width=BIG_W),
             big)):
        run_cfg = write_run(os.path.join(root, f"run{space}"), cfg, sd)
        samples = {k: v[:SERVE_TILE] for k, v in samples.items()}
        with cs.deterministic_cudnn(torch):
            pred = Predictor(serve_config(run_cfg), sd, device=dev)
            refs = {n: pred.predict({k: v[lo:hi]
                                     for k, v in samples.items()},
                                    max_tile=SERVE_TILE)
                    for n, (lo, hi) in (("b1", (0, 1)), ("b3", (1, 4)),
                                        ("b8", (0, 8)))}
            del pred
        free_card(torch)
        out[f"spatial{space}"] = serve_ranks(
            np, gates, os.path.join(root, f"run{space}"), space, samples,
            refs, root)
        cs.emit({"phase": "daemon_leg", **out[f"spatial{space}"],
                 "failed": gates.failed})
    emit_line("daemon", out, gates)


# -------------------------------------------------------- the trainer


def trainer_argv(data):
    return ["--arch", "resnet18_multistage", "--decoder", "upproj",
            "--dtype", "float32", "-b", str(TRAIN_B),
            "--dataset", "packed", "--data-root", data,
            "--height", str(H), "--width", str(W), "--num-sweeps", "5",
            "--print-freq", "1000"]


def torchrun_trainer(gates, argv, out_dir, what):
    """``torchrun --nproc-per-node WORLD`` of ``--trainer-worker``: its
    stdout, the ranks' JSON and the seconds."""
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(WORLD), os.path.abspath(__file__),
           "--trainer-worker", out_dir, "--", *argv]
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    (rc, o, e), = cs.run_procs([cmd], lambda _: env,
                               RANK_TIMEOUT_S["trainer"])
    seconds = time.perf_counter() - t0
    lines = {}
    if gates.check(rc == 0, f"trainer {what}: torchrun exit {rc}",
                   f"{o[-1500:]}\n{e[-3000:]}"):
        for r in range(WORLD):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                lines[r] = json.load(f)
    return o, lines, seconds


def rel_diffs(run_dir, want_dir):
    """phase harness's row comparison of two runs' test.csv, a row an
    epoch."""
    return [cs.row_rel_diff(a, b) for a, b in zip(
        cs.csv_rows(os.path.join(run_dir, "test.csv")),
        cs.csv_rows(os.path.join(want_dir, "test.csv")))]


def resumed_equal(torch, runs) -> dict:
    """Whether the resumed run's last rows (test.csv, train.csv) and last
    checkpoint equal the straight DP run's, bit for bit."""
    from radar_depth_tpu_torch.train import checkpoint as ckpt_lib

    rows = {name: [cs.csv_rows(os.path.join(runs[d], name))[-1]
                   for d in ("dp", "resume")]
            for name in ("test.csv", "train.csv")}
    last = str(TRAIN_EPOCHS - 1)
    pa, pb = (ckpt_lib.load_payload(os.path.join(runs[d], "checkpoints",
                                                 last))["model"]
              for d in ("dp", "resume"))
    return {"rows": all(a[k] == b[k] for a, b in rows.values()
                        for k in cs.CSV_METRICS),
            "model": states_equal(torch, pa, pb)}


def phase_trainer(torch, root, emit_line):
    """(g): train.main over four ranks, data-parallel and --spatial 2,
    against one process at TRAIN_LR; --resume against the straight run;
    then data-parallel at train.main's default learning rate against one
    process at it, under the same gate. A line per leg as it ends
    (``trainer_leg``), then the phase's."""
    from radar_depth_tpu_torch.data import packed

    gates = Gates()
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    [(rc, o, e)] = cs.run_procs(
        [[sys.executable, "-m", "radar_depth_tpu_torch.generate_dataset",
          "--out", data, "--num-train", str(TRAIN_N), "--num-val",
          str(VAL_N), "--height", str(H), "--width", str(W), "--sweeps",
          "5", "--seed", "0"]], lambda i: dict(os.environ, PYTHONPATH=HERE),
        timeout=600)
    out = {"data_s": time.perf_counter() - t0, "global_batch": TRAIN_B,
           "lr": TRAIN_LR, "epochs": TRAIN_EPOCHS, "train_samples": TRAIN_N,
           "val_samples": VAL_N, "dtype": "float32",
           "native_loader": packed.native_error() is None}
    if not gates.check(rc == 0, "trainer: generate_dataset",
                       f"{o[-500:]}{e[-1500:]}"):
        emit_line("trainer", out, gates)
        return
    base = trainer_argv(data)
    lr = ["--lr", str(TRAIN_LR)]
    steps = TRAIN_N // TRAIN_B
    runs = {k: os.path.join(root, k) for k in (
        "one", "one_default_lr", "dp", "resume", "sp", "dp_default_lr")}
    # the two one-process runs at once, on cards 0 and 1
    t0 = time.perf_counter()
    ones = (("one", lr), ("one_default_lr", []))
    procs = cs.run_procs(
        [[sys.executable, "-m", "radar_depth_tpu_torch.train.main", *base,
          *extra, "--epochs", str(TRAIN_EPOCHS), "--output-dir", runs[name]]
         for name, extra in ones],
        lambda i: dict(os.environ, PYTHONPATH=HERE,
                       CUDA_VISIBLE_DEVICES=str(i)),
        RANK_TIMEOUT_S["trainer"])
    seconds = time.perf_counter() - t0
    for (name, _), (rc, o, e) in zip(ones, procs):
        if not gates.check(rc == 0, f"trainer: {name} exit {rc}",
                           f"{o[-500:]}{e[-1500:]}"):
            emit_line("trainer", out, gates)
            return
        out[name] = {
            "seconds": seconds,
            "epochs": [{k: float(r[k]) for k in ("data_time", "gpu_time")}
                       for r in cs.csv_rows(os.path.join(runs[name],
                                                         "train.csv"))]}
    legs = (("dp", lr, TRAIN_EPOCHS, runs["dp"]),
            ("resume_first", lr, 1, runs["resume"]),
            ("resume", lr + ["--resume", runs["resume"]], TRAIN_EPOCHS,
             runs["resume"]),
            ("spatial2", lr + ["--spatial", "2"], TRAIN_EPOCHS, runs["sp"]),
            ("dp_default_lr", [], TRAIN_EPOCHS, runs["dp_default_lr"]))
    # the legs held to a one-process run's test.csv, and to which
    one_process = {"dp": "one", "spatial2": "one",
                   "dp_default_lr": "one_default_lr"}
    for name, extra, epochs, run_dir in legs:
        o, lines, seconds = torchrun_trainer(
            gates, base + extra + ["--epochs", str(epochs), "--output-dir",
                                   run_dir],
            os.path.join(root, f"ranks-{name}"), name)
        rec = {"seconds": seconds}
        out[name] = rec
        if lines:
            first_epoch = 1 if name == "resume" else 0
            n_steps = steps * (epochs - first_epoch)
            rec["per_rank"] = {r: {k: lines[r][k] for k in (
                "device", "mesh", "train_graphs", "epochs")} for r in lines}
            for r, line in lines.items():
                gates.check(line["device"] == f"cuda:{r}",
                            f"trainer {name} rank {r}: device",
                            line["device"])
                gates.check(line["train_graphs"] == graph_stats(n_steps),
                            f"trainer {name} rank {r}: train step graphs",
                            line["train_graphs"])
            gates.check(f"replicas bit-equal on {WORLD} ranks" in o,
                        f"trainer {name}: no replicas line", o[-800:])
            rec["rows"] = [{k: float(r[k]) for k in cs.CSV_METRICS}
                           for r in cs.csv_rows(os.path.join(run_dir,
                                                             "test.csv"))]
            if name in one_process:
                rels = rel_diffs(run_dir, runs[one_process[name]])
                rec["row_rel_diff_vs_one_process"] = rels
                gates.check(len(rels) == TRAIN_EPOCHS
                            and max(rels) <= cs.RESUME_RTOL,
                            f"trainer {name}: test.csv vs one process", rels)
            elif name == "resume" and "rows" in out["dp"]:
                rec["bit_equal_to_dp"] = resumed_equal(torch, runs)
                gates.check(all(rec["bit_equal_to_dp"].values()),
                            "trainer: --resume differs from the straight "
                            "run", rec["bit_equal_to_dp"])
        cs.emit({"phase": "trainer_leg", "leg": name,
                 **{k: v for k, v in rec.items() if k != "per_rank"},
                 "rank0": rec.get("per_rank", {}).get(0),
                 "failed": gates.failed})
    emit_line("trainer", out, gates)


# -------------------------------------------------------------- main


def nvidia_smi_all() -> dict:
    def run(args):
        try:
            return subprocess.run(["nvidia-smi", *args], capture_output=True,
                                  text=True, timeout=60).stdout.strip()
        except (OSError, subprocess.SubprocessError) as e:
            return f"nvidia-smi failed: {e}"

    return {"cards": run(["--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"]).splitlines(),
            "topo": run(["topo", "-m"]),
            "nvlink_card0": run(["nvlink", "--status", "-i", "0"])}


def peer_access(torch) -> list:
    """Whether card i reads card j's memory directly (P2P), each pair."""
    n = torch.cuda.device_count()
    return [[i == j or torch.cuda.can_device_access_peer(i, j)
             for j in range(n)] for i in range(n)]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--trainer-worker"]:
        rest = argv[2:]
        return trainer_worker(argv[1], rest[1:] if rest[:1] == ["--"]
                              else rest)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="dp,spatial,daemon,trainer")
    ap.add_argument("--out", default="chiprun_out/multicard.json")
    ap.add_argument("--worker", nargs=2, metavar=("GROUP", "DIR"),
                    help="run one rank of GROUP on the files in DIR (the "
                         "script starts these itself)")
    args = ap.parse_args(argv)
    cs.HTTP_TIMEOUT = REQUEST_S

    import torch

    if args.worker:
        group, root = args.worker
        return {"dp": worker_dp, "spatial": worker_spatial}[group](root)
    if not torch.cuda.is_available():
        print("chip_smoke_multicard: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < WORLD:
        print(f"chip_smoke_multicard: {torch.cuda.device_count()} cards, "
              f"needs {WORLD}; nothing was run", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
        from radar_depth_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke_multicard: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    import shutil
    import tempfile

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    results, failed = {}, {}

    def save(wall=None):
        """--out as it stands: rewritten after every phase."""
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump({"device": {"kind": kind, "count": count, **smi},
                           "phases": results, "wall": wall,
                           "failed": failed}, f, indent=1)

    def emit_line(phase, out, gates):
        line = {"phase": phase, **out, "failed": gates.failed,
                "ok": not gates.failed}
        cs.emit(line)
        results[phase] = line
        if gates.failed:
            failed[phase] = gates.failed
        save()

    built = kernels.build()
    smi = nvidia_smi_all()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi["peer_access"] = peer_access(torch)
    cs.emit({"phase": "device", "kind": kind, "count": count,
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "nccl": str(torch.cuda.nccl.version()),
             "build_s": time.perf_counter() - t_start,
             "nvcc": built, **smi})
    from radar_depth_tpu_torch.data import packed

    packed.native_error()  # build native/librdtp.so before any rank

    t0 = time.perf_counter()
    spec = SampleSpec(height=H, width=W, num_sweeps=5)
    n = max(B_RANK_BF16, 2 * B_DP, SERVE_TILE)
    batch = SyntheticNuScenes(n, spec=spec, seed=0).batch(range(n))
    big = SyntheticNuScenes(SERVE_TILE, spec=SampleSpec(
        height=BIG_H, width=BIG_W, num_sweeps=5), seed=1).batch(
            range(SERVE_TILE))
    sd = cs.train_init(torch, cs.train_setup(
        torch, cs.train_config("float32"), "cpu")[0],
        SEED_WEIGHTS).state_dict()
    cs.emit({"phase": "data", "seconds": time.perf_counter() - t0,
             "samples": n, "big_samples": SERVE_TILE,
             "weights_seed": SEED_WEIGHTS})
    laps = {}
    tmp = tempfile.mkdtemp(prefix="rdt-multicard-")
    phases = args.phases.split(",")
    try:
        for group in phases:
            t0 = time.perf_counter()
            root = os.path.join(tmp, group)
            if group == "dp":
                phase_dp(torch, np, dev, batch, sd, root, emit_line)
            elif group == "spatial":
                phase_spatial(torch, np, dev, batch,
                              {k: v[:B_BIG] for k, v in big.items()}, sd,
                              root, emit_line)
            elif group == "daemon":
                phase_daemon(torch, np, dev, batch, big, sd, root,
                             emit_line)
            elif group == "trainer":
                phase_trainer(torch, root, emit_line)
            else:
                raise SystemExit(f"unknown phase group {group!r}")
            laps[group] = time.perf_counter() - t0
            free_card(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wall = {"phase": "wall", "seconds": time.perf_counter() - t_start,
            "group_seconds": laps}
    cs.emit(wall)
    save(wall)
    for line in smi["cards"]:
        print(line, flush=True)
    print(smi["topo"], flush=True)
    print(smi["nvlink_card0"], flush=True)
    if failed:
        print(f"chip_smoke_multicard: failed checks in "
              f"{sorted(failed)}", file=sys.stderr)
        return 1
    cs.emit({"ok": True, "device": {"platform": "gpu",
                                    "kind": kind, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
