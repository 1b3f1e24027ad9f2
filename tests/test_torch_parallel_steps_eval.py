"""The port's data-parallel eval pass and two-axis meshes (parallel/mesh.py
through train/step.py) in two gloo processes on the CPU: 5 samples at eval
batch 4, the ragged second batch padded and split 2/2, in both metric
conventions and under --sparsifier uar, against the port's single process
and (both conventions) the JAX eval step jitted on a 2-device CPU mesh;
and the metric sums over a (2, 1) and a (1, 2) ``make_mesh_2d`` layout.
The cases, the worker, the references and the tolerances are tests/
torch_parallel_cases.py's (its docstring).
"""

import pytest

from tests import torch_parallel_cases as cases
from tests.torch_parallel_cases import (  # noqa: F401  (fixtures)
    few_threads,
    native_float32_convs,
)


@pytest.fixture(autouse=True)
def _threads_and_convs(few_threads, native_float32_convs):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield from cases.start(tmp_path_factory, [], evals=True, layouts=True)


@pytest.mark.parametrize("conv", list(cases.EVAL_CASES))
def test_ragged_eval_matches_one_process(runs, conv):
    cases.check_ragged_eval_matches_one_process(runs, conv)


@pytest.mark.parametrize("conv", cases.CONVENTIONS)
def test_ragged_eval_matches_jax_mesh(runs, conv):
    cases.check_ragged_eval_matches_jax_mesh(runs, conv)


@pytest.mark.parametrize("layout", list(cases.LAYOUTS))
def test_two_axis_mesh_matches_flat(runs, layout):
    cases.check_two_axis_mesh_matches_flat(runs, layout)
