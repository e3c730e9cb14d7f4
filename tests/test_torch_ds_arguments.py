"""The port's ``add_config_arguments`` and public surface against the JAX
package's: the cases of tests/unit/test_ds_arguments.py run through both
parsers and compared, ``initialize(args=...)`` reading the config path
(and its deprecated alias), and the names the JAX package exports."""

import argparse
import json

import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
import torch_dp_ranks as ranks
from torch_test_env import jax_compile_cache  # noqa: F401


def basic_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--num_epochs", type=int)
    return parser


ARGVS = [
    ["--num_epochs", "2"],
    ["--num_epochs", "2", "--deepspeed", "--deepspeed_config", "ds.json"],
    ["--deepspeed"],
    ["--deepscale", "--deepscale_config", "ds.json"],
    ["--deepspeed_mpi"],
    [],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_parsed_arguments_equal_the_jax_parsers(argv):
    port = deepspeed_tpu_torch.add_config_arguments(basic_parser())
    jax_parser = deepspeed_tpu.add_config_arguments(basic_parser())
    assert vars(port.parse_args(argv)) == vars(jax_parser.parse_args(argv))


def test_no_ds_arguments_no_ds_parser():
    args = basic_parser().parse_args(["--num_epochs", "2"])
    assert args.num_epochs == 2
    assert not hasattr(args, "deepspeed")
    assert not hasattr(args, "deepspeed_config")


def test_defaults():
    args = deepspeed_tpu_torch.add_config_arguments(
        basic_parser()).parse_args([])
    assert args.deepspeed is False and args.deepspeed_config is None
    assert args.deepscale is False and args.deepscale_config is None
    assert args.deepspeed_mpi is False


@pytest.mark.parametrize("flag", ["--deepspeed_config", "--deepscale_config"])
def test_engine_reads_config_path_from_args(tmp_path, flag):
    """initialize(args=...) takes the config from the flag or its
    deprecated alias, as the JAX engine does
    (tests/unit/test_ds_arguments.py)."""
    cfg_path = tmp_path / "ds.json"
    cfg_path.write_text(json.dumps({
        "train_batch_size": 8,
        "optimizer": {"type": "Adam", "params": {"lr": 1e-3}},
    }))
    parser = deepspeed_tpu_torch.add_config_arguments(
        argparse.ArgumentParser())
    args = parser.parse_args([flag, str(cfg_path)])
    engine, *_ = deepspeed_tpu_torch.initialize(
        args=args, model=ranks.torch_mlp(ranks.mlp_weights()), device="cpu")
    assert engine.train_batch_size() == 8
    x = torch.zeros((8, ranks.IN_DIM))
    y = torch.zeros((8,), dtype=torch.long)
    assert torch.isfinite(engine.train_batch([(x, y)]))


def test_the_port_exports_what_the_jax_package_exports():
    """Every name of the JAX package's ``__all__``, each a module, class
    or function of the port."""
    jax_names = set(deepspeed_tpu.__all__)
    assert jax_names <= set(deepspeed_tpu_torch.__all__)
    for name in jax_names:
        assert getattr(deepspeed_tpu_torch, name) is not None
    assert (deepspeed_tpu_torch.__version__
            == deepspeed_tpu_torch.version.__version__)
    from deepspeed_tpu_torch.ops import optimizers

    for name in ("Optimizer", "Adam", "Lamb", "Lion", "SGD"):
        assert getattr(deepspeed_tpu_torch, name) is getattr(optimizers, name)
