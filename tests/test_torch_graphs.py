"""radar_depth_tpu_torch/graphs.py: the per-shape graphs of the served
forward and the train step, on the CPU with a stand-in for the CUDA capture
(tests/torch_graph_capture.py).

The eager path (held to the JAX package by the other test files) and the
graphed path must give the same bits on the CPU: the flagship at 64x96,
B=2, float32. tests/test_torch_graphs_eval.py holds the eval paths and the
artifact, tests/test_torch_graphs_mesh.py the steps over a process group. On the card, tests/test_torch_gpu.py and phase ``graphs`` of
chip_smoke.py hold the real graphs to the eager path.
"""

from contextlib import nullcontext

import numpy as np
import pytest
import torch

from radar_depth_tpu_torch import bench, graphs
from radar_depth_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
    ServeConfig,
    TrainConfig,
)
from radar_depth_tpu_torch.data import SampleSpec, SyntheticNuScenes
from radar_depth_tpu_torch.inference import Predictor
from radar_depth_tpu_torch.models import create_model, init_random
from radar_depth_tpu_torch.ops.preprocess import PreprocessConfig
from radar_depth_tpu_torch.parallel.mesh import DataMesh
from radar_depth_tpu_torch.train.state import (
    create_train_state,
    load_state_dict,
    state_to_dict,
)
from radar_depth_tpu_torch.train.step import make_train_step
from tests.torch_graph_capture import (  # noqa: F401  (fixture)
    Recorder,
    capture_on_cpu,
)

H, W, SWEEPS, B = 64, 96, 2, 2
ARCH = "resnet18_multistage"
SPEC = SampleSpec(height=H, width=W, num_sweeps=SWEEPS)


class Counter:
    launches = 0


def _toy(capture=None, **kw):
    """A ShapeGraphs over a one-layer model whose function counts 3 launches
    of a counter per run and returns model(x) * 2."""
    model = torch.nn.Linear(3, 4)
    counter = Counter()
    runs = []

    def fn(x):
        runs.append(1)
        counter.launches += 3
        return model(x) * 2

    g = graphs.ShapeGraphs(fn, model,
                           capture=capture or Recorder(counters=[counter]),
                           counters=lambda: [counter], **kw)
    return g, model, counter, runs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small steps gain little from more, and the
    suite runs files side by side on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- ShapeGraphs


def test_call_one_eager_call_two_captures_and_replays_once():
    g, model, counter, runs = _toy()
    x = torch.ones(2, 3)
    with torch.no_grad():
        want = model(x) * 2
    assert torch.equal(g(x), want) and len(runs) == 1
    assert g.stats == {"eager": 1, "captures": 0, "replays": 0}
    assert torch.equal(g(x), want)
    # the capture ran once (state put back), the replay once
    assert len(runs) == 3 and g.capture.calls == [0]
    assert g.stats == {"eager": 1, "captures": 1, "replays": 1}
    assert torch.equal(g(x + 1), model(x + 1) * 2)
    assert len(runs) == 4 and g.stats["replays"] == 2
    # every call counted once: 3 launches each, the capture's taken back
    assert counter.launches == 9


@pytest.mark.parametrize("change", ["shape", "dtype", "training", "lr",
                                    "storage", "flags"])
def test_each_part_of_the_key_captures_anew(change):
    g, model, _, _ = _toy()
    x = torch.ones(2, 3)
    key = (True, 0.01)
    for _ in range(3):
        g(x, key=key)
    assert g.stats["captures"] == 1
    if change == "shape":
        x = torch.ones(5, 3)
    elif change == "dtype":
        model.double()
        x = x.double()
    elif change == "training":
        key = (False, 0.01)
    elif change == "lr":
        key = (True, 0.001)
    elif change == "storage":
        model.weight = torch.nn.Parameter(model.weight.detach().clone())
    torch.backends.cudnn.benchmark, old = (change == "flags"), \
        torch.backends.cudnn.benchmark
    try:
        g(x, key=key)  # call 1 at the new key: eager
        assert g.stats["captures"] == 1 and g.stats["eager"] == 2
        g(x, key=key)
    finally:
        torch.backends.cudnn.benchmark = old
    assert g.stats["captures"] == 2


def test_load_state_dict_in_place_keeps_the_graph():
    g, model, _, _ = _toy()
    x = torch.ones(2, 3)
    g(x), g(x)
    sd = {k: v + 1 for k, v in model.state_dict().items()}
    model.load_state_dict(sd)  # copies into the same storage
    with torch.no_grad():
        want = model(x) * 2
    assert torch.equal(g(x), want)
    assert g.stats == {"eager": 1, "captures": 1, "replays": 2}


def test_replays_return_fresh_tensors():
    g, model, _, _ = _toy(fresh=lambda out: out.clone())
    outs = [g(torch.full((2, 3), float(i))) for i in range(4)]
    with torch.no_grad():
        for i, out in enumerate(outs):
            assert torch.equal(out, model(torch.full((2, 3), float(i))) * 2)


@pytest.mark.parametrize("hook", ["pre_hook", "hook", "global"])
def test_hooks_send_calls_to_the_eager_path(hook):
    g, model, counter, runs = _toy()
    fired = []
    register = {"pre_hook": model.register_forward_pre_hook,
                "hook": model.register_forward_hook,
                "global": torch.nn.modules.module.
                register_module_forward_hook}[hook]
    handle = register(lambda *a: fired.append(1))
    try:
        for _ in range(4):
            g(torch.ones(2, 3))
    finally:
        handle.remove()
    assert len(fired) == 4 and len(runs) == 4
    assert g.stats == {"eager": 4, "captures": 0, "replays": 0}
    assert not g._graphs  # a hooked call remembers no key
    g(torch.ones(2, 3)), g(torch.ones(2, 3))
    assert g.stats["captures"] == 1


def test_disable_graphs_and_unregistrable_generators_run_eagerly():
    g, _, _, runs = _toy(capture=Recorder(generators=False))
    gen = torch.Generator()
    for _ in range(3):
        g(torch.ones(2, 3), generators=(gen,))
    with graphs.disable_graphs():
        for _ in range(3):
            g(torch.ones(2, 3))
    assert g.stats == {"eager": 6, "captures": 0, "replays": 0}
    assert len(runs) == 6 and not g._graphs


def test_a_failed_capture_raises_and_never_runs_eagerly():
    g, _, counter, runs = _toy(capture=Recorder(fail=True))
    g(torch.ones(2, 3))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture failed"):
            g(torch.ones(2, 3))
    assert len(runs) == 1 and counter.launches == 3


def test_least_recently_used_graph_is_dropped():
    g, _, _, _ = _toy(max_graphs=2)
    for n in (1, 2, 1, 2, 3, 3):
        g(torch.ones(n, 3))
    assert [k[1][0][0][0] for k in g._graphs] == [2, 3]


@pytest.mark.parametrize("case,want", [
    (dict(device="cpu"), False), (dict(device="cuda"), True),
    (dict(device="cuda", plain=True), False),
    (dict(device="cuda", mesh=DataMesh(group=object())), False),
    (dict(device="cuda", mesh=DataMesh(group=object(), backend="gloo")),
     False),
    (dict(device="cuda", mesh=DataMesh(group=object(), backend="nccl")),
     True),
    (dict(device="cuda", mesh=DataMesh(group=object(), backend="nccl",
                                       axis_names=("replica", "data"),
                                       shape=(2, 2))), True),
    (dict(device="cuda", mesh=DataMesh(group=object(), backend="nccl",
                                       axis_names=("data", "space"),
                                       shape=(1, 2), space_size=2)), True),
    (dict(device="cuda", mesh=DataMesh(group=object(), backend="gloo",
                                       axis_names=("data", "space"),
                                       shape=(1, 2), space_size=2)), False),
    (dict(device="cuda", plain=True,
          mesh=DataMesh(group=object(), backend="nccl")), False),
    (dict(device="cuda", mesh=DataMesh()), True)])
def test_wanted_on_the_card_with_kernels_without_a_group_or_over_nccl(
        case, want):
    """The card with the kernels captures without a process group (a mesh
    without one is no group) and over an NCCL group, with or without a
    space axis; a gloo group (spatial or not), ``plain`` and the CPU run
    eagerly."""
    assert graphs.wanted(**case) == want


# ------------------------------------------------------ the entry points


def _batch(seed, n=B):
    return SyntheticNuScenes(n, spec=SPEC, seed=seed).batch(range(n))


def _serve_cfg():
    return ServeConfig(arch=ARCH, decoder="upproj", height=H, width=W,
                       num_sweeps=SWEEPS)


@pytest.fixture(scope="module")
def served_weights():
    model, _ = create_model(ARCH, device="cpu", output_size=(H, W))
    return init_random(model, 0).state_dict()


def test_predictor_graph_path_matches_eager(capture_on_cpu, served_weights):
    eager = Predictor(_serve_cfg(), served_weights, device="cpu")
    assert eager.graphs is not None
    eager.graphs = None
    graphed = Predictor(_serve_cfg(), served_weights, device="cpu")
    graphed.graphs.capture = Recorder()
    for seed in range(3):
        b = _batch(seed)
        assert np.array_equal(graphed.predict(b), eager.predict(b))
    stream = [_batch(seed) for seed in range(3, 6)]
    got = list(graphed.predict_stream(stream, depth=2))
    want = list(eager.predict_stream(stream, depth=2))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert graphed.graphs.stats == {"eager": 1, "captures": 1, "replays": 5}
    # keep gets copies of what the call's replay wrote: a later call at the
    # same tile shape, without keep (the daemon's), leaves them as they were
    graphed.keep = keep = {}
    graphed.predict(_batch(9))
    graphed.keep = None
    graphed.predict(_batch(10))
    eager.keep = want_keep = {}
    eager.predict(_batch(9))
    assert torch.equal(keep["out"][1], want_keep["out"][1])
    assert torch.equal(keep["prepared"]["radar"],
                       want_keep["prepared"]["radar"])


def test_bench_infer_fn_graph_path_keeps_each_replay(capture_on_cpu):
    model, arch_spec = create_model(ARCH, device="cpu", output_size=(H, W))
    init_random(model, 0)
    pre = PreprocessConfig(spec=SPEC)
    eager_keep, keep = {}, {}
    with graphs.disable_graphs():
        eager = bench.make_infer_fn(model, arch_spec, pre,
                                    torch.device("cpu"), eager_keep)
    infer = bench.make_infer_fn(model, arch_spec, pre, torch.device("cpu"),
                                keep)
    infer.graphs.capture = Recorder()
    for seed in range(3):
        b = _batch(seed)
        got = infer(b)
        with graphs.disable_graphs():
            want = eager(b)
        assert torch.equal(got, want)
        assert torch.equal(keep["prepared"]["radar"],
                           eager_keep["prepared"]["radar"])
    assert infer.graphs.stats == {"eager": 1, "captures": 1, "replays": 2}


def _train_cfg(**optim):
    return TrainConfig(data=DataConfig(height=H, width=W, num_sweeps=SWEEPS),
                       model=ModelConfig(arch=ARCH, decoder="upproj"),
                       optim=OptimConfig(**optim), batch_size=B)


def _trainer(cfg, steps_per_epoch=2):
    model, arch_spec = create_model(ARCH, device="cpu", output_size=(H, W))
    init_random(model, 0)
    state = create_train_state(model, cfg.optim, steps_per_epoch)
    step = make_train_step(model, arch_spec, cfg, host_augmented=True)
    step.graphs.capture = Recorder(lambda: [
        *model.parameters(), *model.buffers(),
        *(t for s in state.optimizer.state.values() for t in s.values())])
    return state, step


def _state_tensors(state):
    return ([t.detach() for t in state.model.state_dict().values()]
            + [s["momentum_buffer"] for s in state.optimizer.state.values()])


@pytest.fixture(autouse=True)
def native_float32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_train_steps_on_the_graph_equal_eager_steps(capture_on_cpu):
    """Five steps with a learning-rate decay after three (steps_per_epoch
    3, decay every epoch): parameters, momentum, BN running statistics and
    every step's sums bit-equal; the sums of step 1 survive the later
    steps (``bench.py``'s ``first_sums``); the decay captures anew."""
    cfg = _train_cfg(lr_decay_epochs=1)
    batches = [_batch(s) for s in range(5)]
    got = {}
    for graphed in (False, True):
        state, step = _trainer(cfg, steps_per_epoch=3)
        with graphs.disable_graphs() if not graphed else nullcontext():
            sums = [step(state, b) for b in batches]
        got[graphed] = (sums, _state_tensors(state))
        if graphed:
            assert step.graphs.stats == {"eager": 2, "captures": 2,
                                         "replays": 3}
            assert state.step == 5
    for a, b in zip(got[True][0], got[False][0]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))


def test_optimizer_load_state_dict_captures_anew(capture_on_cpu):
    cfg = _train_cfg()
    state, step = _trainer(cfg)
    b = _batch(0)
    for _ in range(3):
        step(state, b)
    assert step.graphs.stats["captures"] == 1
    load_state_dict(state, state_to_dict(state))  # what --resume does
    step.graphs.capture.state = lambda: [
        *state.model.parameters(), *state.model.buffers(),
        *(t for s in state.optimizer.state.values() for t in s.values())]
    step(state, b)  # new momentum buffers: call 1 at a new key
    assert step.graphs.stats["captures"] == 1
    step(state, b)
    assert step.graphs.stats["captures"] == 2
    assert len(step.graphs._graphs) == 1  # the train step keeps one graph


def test_train_step_eager_under_a_mesh_and_a_cpu_generator(capture_on_cpu,
                                                           monkeypatch):
    cfg = _train_cfg()
    model, arch_spec = create_model(ARCH, device="cpu", output_size=(H, W))
    assert make_train_step(model, arch_spec, cfg,
                           mesh=DataMesh(group=object())).graphs is None
    assert make_train_step(model, arch_spec, cfg, plain=True).graphs is None
    init_random(model, 0)
    state = create_train_state(model, cfg.optim, 10)
    step = make_train_step(model, arch_spec, cfg)  # augments in the step
    step.graphs.capture = Recorder()
    # the step was built to capture; the CPU's generator is no card's
    monkeypatch.setattr(graphs, "CAPTURE_DEVICES", ("cuda",))
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(state, _batch(0), generator=gen)
    assert step.graphs.stats == {"eager": 0, "captures": 0, "replays": 0}
    assert step.graphs.capture.calls == []


def test_given_draws_go_up_before_the_graph(capture_on_cpu):
    """A step augmenting in the step with ``aug_params`` given (JAX's draws,
    numpy) draws nothing: the arrays go to the device before the capture,
    and the graphed steps equal the eager ones."""
    cfg = _train_cfg()
    rng = np.random.default_rng(0)
    augs = [(rng.uniform(1, 1.5, B).astype(np.float32),
             rng.uniform(-0.08, 0.08, B).astype(np.float32),
             rng.random(B) < 0.5,
             rng.uniform(0.6, 1.4, (B, 3)).astype(np.float32))
            for _ in range(3)]
    got = {}
    for graphed in (False, True):
        model, arch_spec = create_model(ARCH, device="cpu",
                                        output_size=(H, W))
        init_random(model, 0)
        state = create_train_state(model, cfg.optim, 10)
        step = make_train_step(model, arch_spec, cfg)
        step.graphs.capture = Recorder(lambda: [
            *model.parameters(), *model.buffers(),
            *(t for s in state.optimizer.state.values()
              for t in s.values())])
        with graphs.disable_graphs() if not graphed else nullcontext():
            sums = [step(state, _batch(i), aug_params=a)
                    for i, a in enumerate(augs)]
        got[graphed] = (sums, _state_tensors(state))
        if graphed:
            assert step.graphs.stats == {"eager": 1, "captures": 1,
                                         "replays": 2}
            assert step.graphs.capture.calls == [0]
    for a, b in zip(got[True][0], got[False][0]):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(got[True][1], got[False][1]))
