"""Finetuning on the fabricated birds scene by the shipped config
(``configs/train/ft/neuray_ft_depth_birds.yaml``),
the port against the JAX package: ``tests/test_torch_port_ft_databases.py``
holds the checks, the scene and the tolerances."""
import pytest
import torch

from tests.test_torch_port_ft_databases import (  # noqa: F401 (fixture)
    build, check_init, check_split, check_step, weights)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def birds(tmp_path_factory, weights):
    return build("birds", tmp_path_factory, weights)


def test_birds_split_equals_jax(birds):
    check_split(birds)


def test_birds_padded_refs_and_init_equal_jax(birds):
    check_init(birds)


def test_birds_step_matches_jax(birds):
    check_step(birds)
