"""Finetuning on the fabricated desktop scene by the shipped config
(``configs/train/ft/example/neuray_ft_desktop_pretrain.yaml``),
the port against the JAX package: ``tests/test_torch_port_ft_databases.py``
holds the checks, the scene and the tolerances."""
import pytest
import torch

from tests.test_torch_port_ft_databases import (  # noqa: F401 (fixture)
    build, check_init, check_split, check_step, weights)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def desktop(tmp_path_factory, weights):
    return build("desktop", tmp_path_factory, weights)


def test_desktop_split_equals_jax(desktop):
    check_split(desktop)


def test_desktop_padded_refs_and_init_equal_jax(desktop):
    check_init(desktop)


def test_desktop_step_matches_jax(desktop):
    check_step(desktop)
