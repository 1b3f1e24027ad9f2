"""A stand-in for the CUDA capture of ``radar_depth_tpu_torch/graphs.py``,
so that the graphed paths run on the CPU (tests/test_torch_graphs*.py).

The stand-in records each capture; like a real capture it computes nothing
that stays (the model and optimizer state it runs over, and the generators'
states, are put back), and its replay runs the captured function again into
the same output tensors, taking back what that run adds in Python to the
kernels' launch counters, to ``parallel/mesh.py::COLLECTIVES`` and to
``parallel/spatial.py::HALO``, since a real replay runs no Python. So the eager path and the graphed path must
give the same bits on the CPU.
"""

import pytest
import torch

from radar_depth_tpu_torch import graphs
from radar_depth_tpu_torch.parallel.mesh import COLLECTIVES
from radar_depth_tpu_torch.parallel.spatial import HALO


def leaves(tree):
    out = []
    graphs._flatten(tree, out)
    return out


class Recorder:
    """Stand-in for ``graphs.CudaCapture``: records each capture (the
    number of generators registered), puts back the tensors of ``state()``
    and the generators' states after running the function once, and replays
    it into the same output tensors (``Replay``). ``fail=True`` raises at
    capture; ``generators=False`` stands for a torch that cannot register
    one. ``counters``: the objects whose ``.launches`` a replay leaves as
    they were (default: the kernels' own, ``graphs.kernel_counters``)."""

    def __init__(self, state=lambda: [], generators=True, fail=False,
                 counters=None):
        self.state, self.fail, self._generators = state, fail, generators
        self.counters = counters
        self.calls = []

    def supports_generators(self):
        return self._generators

    def __call__(self, fn, generators=()):
        self.calls.append(len(generators))
        if self.fail:
            raise RuntimeError("capture failed")
        with torch.no_grad():
            saved = [t.clone() for t in self.state()]
        drawn = [g.get_state() for g in generators]
        out = fn()
        with torch.no_grad():
            for t, s in zip(self.state(), saved):
                t.copy_(s)
        for g, s in zip(generators, drawn):
            g.set_state(s)
        counters = (graphs.kernel_counters() if self.counters is None
                    else self.counters)
        return Replay(fn, out, counters), out


class Replay:
    def __init__(self, fn, out, counters):
        self.fn, self.out, self.counters = fn, out, counters

    def replay(self):
        before = [c.launches for c in self.counters]
        collectives, halo = dict(COLLECTIVES), dict(HALO)
        new = self.fn()
        for c, n in zip(self.counters, before):
            c.launches = n
        for counter, saved in ((COLLECTIVES, collectives), (HALO, halo)):
            counter.clear()
            counter.update(saved)
        with torch.no_grad():
            for static, t in zip(leaves(self.out), leaves(new)):
                static.copy_(t)


@pytest.fixture
def capture_on_cpu(monkeypatch):
    monkeypatch.setattr(graphs, "CAPTURE_DEVICES", ("cuda", "cpu"))
