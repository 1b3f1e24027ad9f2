"""The port's data-parallel train step (parallel/mesh.py through
train/step.py) in two gloo processes on the CPU, in the rest of the train
cases: --metric-avg sample and --sparsifier uar with JAX's draws (also held
against the JAX step jitted on a 2-device CPU mesh), and against the port
alone --remat, --sparsifier uar and the augmentation drawn from a seeded
generator for the global batch, and a mesh step whose model later also
gets a step without the mesh; each in float32 and float64, against the
port's single-process step and across ranks. The cases, the worker, the
references and the tolerances are tests/torch_parallel_cases.py's (its
docstring).
"""

import pytest

from tests import torch_parallel_cases as cases
from tests.torch_parallel_cases import (  # noqa: F401  (fixtures)
    few_threads,
    native_float32_convs,
)

JAX = ["accum1-sample", "sparsifier"]
TRAIN = JAX + ["remat", "sparsifier-drawn", "augment-drawn",
               "plain-built-after"]


@pytest.fixture(autouse=True)
def _threads_and_convs(few_threads, native_float32_convs):  # noqa: F811
    yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield from cases.start(tmp_path_factory, TRAIN)


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_matches_one_process(runs, name):
    cases.check_train_step_matches_one_process(runs, name)


@pytest.mark.parametrize("name", JAX)
def test_train_step_matches_jax_mesh(runs, name):
    cases.check_train_step_matches_jax_mesh(runs, name)


@pytest.mark.parametrize("name", TRAIN)
def test_ranks_stay_bit_equal(runs, name):
    cases.check_ranks_stay_bit_equal(runs, name)
