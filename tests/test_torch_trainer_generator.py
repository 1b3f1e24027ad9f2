"""The Trainer's one generator (radar_depth_tpu_torch/train/loop.py): the
in-step augmentation of epoch e draws from one ``torch.Generator`` of the
Trainer's, seeded again at the start of each epoch, where it once made a
new generator every epoch. A generator is part of the train step's graph
key (graphs.py) and the step keeps one graph, so a new generator each epoch
ran one eager step and captured again every epoch; the JAX Trainer compiles
its step once, the epoch entering as a key argument.

On the CPU, with the stand-in capture of tests/torch_graph_capture.py (the
CPU admitted as a capturing device, its generators as the card's are): the
reseeded generator draws bit for bit what a new
generator of the epoch's seed draws, over epochs 0-2, after a partial epoch
too; and a 3-epoch Trainer (the flagship at 64x96, B=2, synthetic data,
so the augmentation runs in the step) captures its train step once, its
train and validation metrics equal to the same run's under
``graphs.disable_graphs()``.
"""

from contextlib import nullcontext

import pytest
import torch

from radar_depth_tpu_torch import graphs
from radar_depth_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
from radar_depth_tpu_torch.ops.augment import sample_affine_params
from radar_depth_tpu_torch.train.loop import Trainer
from tests.torch_graph_capture import (  # noqa: F401  (fixture)
    Recorder,
    capture_on_cpu,
)

H, W, SWEEPS, B = 64, 96, 2, 2
EPOCHS = 3
TIMING = ("data_time", "gpu_time")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def native_float32_convs():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _cfg(tmp_path, name):
    return TrainConfig(
        data=DataConfig(height=H, width=W, num_sweeps=SWEEPS, num_train=4,
                        num_val=2),
        model=ModelConfig(arch="resnet18_multistage", decoder="upproj"),
        batch_size=B, epochs=EPOCHS, platform="cpu", print_freq=1000,
        val_viz_every=1000, output_dir=str(tmp_path / name))


def _epoch_seed(cfg, epoch):
    """The seed of epoch ``epoch``'s draws, as the Trainer has always
    derived it."""
    return (cfg.seed * 1_000_003 + epoch) & ((1 << 63) - 1)


def _draws(gen, cfg):
    params = sample_affine_params(gen, cfg.augment, B)
    return [*params, torch.rand((B, H, W), generator=gen)]


def test_reseeded_generator_draws_as_a_new_one_each_epoch(tmp_path):
    """Epochs 0-2: the same object every epoch, and its draws (the
    augmentation's parameters and the sparsifier's uniforms), twice in an
    epoch and with a partly used epoch before the next, bit-equal to those
    of a new generator seeded for the epoch."""
    trainer = Trainer(_cfg(tmp_path, "gen"))
    try:
        gens = []
        for epoch in range(EPOCHS):
            gen = trainer._epoch_generator(epoch)
            gens.append(gen)
            new = torch.Generator().manual_seed(_epoch_seed(trainer.cfg,
                                                            epoch))
            for _ in range(2 if epoch != 1 else 1):
                for got, want in zip(_draws(gen, trainer.cfg),
                                     _draws(new, trainer.cfg)):
                    assert torch.equal(got, want)
        assert all(g is gens[0] for g in gens)
        assert gens[0] is trainer._generator
    finally:
        trainer.close()


def _run(tmp_path, mode):
    """A 3-epoch run: per epoch the train and validation metrics without
    the timing fields, and the train step's graph stats and captures."""
    trainer = Trainer(_cfg(tmp_path, mode))
    step = trainer._train_step
    step.graphs.capture = Recorder(lambda: [
        *trainer.model.parameters(), *trainer.model.buffers(),
        *(t for s in trainer.state.optimizer.state.values()
          for t in s.values())])
    trainer._eval_step.graphs.capture = Recorder()
    trainer._predict.graphs.capture = Recorder()
    with graphs.disable_graphs() if mode == "eager" else nullcontext():
        trainer.fit()
    metrics = [{part: {k: v for k, v in h[part].items() if k not in TIMING}
                for part in ("train", "val")} for h in trainer.history]
    # fit closed the Trainer: its graphs were released before its mesh
    assert not any(fn.graphs._graphs for fn in (
        step, trainer._eval_step, trainer._predict))
    return metrics, dict(step.graphs.stats), step.graphs.capture.calls


def test_three_epoch_trainer_captures_its_train_step_once(
        tmp_path, capture_on_cpu):
    """Two steps an epoch: the first step of the run eager, the second
    captured with the generator registered (one capture, one generator),
    the other four replays; the metrics of every epoch equal the eager
    run's."""
    got, stats, calls = _run(tmp_path, "graph")
    want, eager_stats, _ = _run(tmp_path, "eager")
    steps = EPOCHS * 4 // B
    assert stats == {"eager": 1, "captures": 1, "replays": steps - 1}
    assert calls == [1]
    assert eager_stats == {"eager": steps, "captures": 0, "replays": 0}
    assert len(got) == EPOCHS
    assert got == want
