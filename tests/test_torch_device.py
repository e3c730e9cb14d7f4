"""The port's entry points run on the card unless asked for the CPU.

These tests pin the no-GPU behaviour, so each first checks that this
machine has no CUDA device (on the card the same calls would run the
kernels; tests/test_torch_cuda_kernels.py covers that)."""

import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch import GPT2Config, GPT2LMHeadModel
from deepspeed_tpu_torch.inference.decode import init_kv_pool
from deepspeed_tpu_torch.ops import attention, decode_attention, fused_lamb
from deepspeed_tpu_torch.ops import kernel_lib
from torch_test_env import jax_compile_cache  # noqa: F401

TINY = GPT2Config(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                  n_head=4)
BLOCK = {"inference": {"max_batch_slots": 2, "max_seq_len": 48,
                       "prefill_len": 32, "kv_block_size": 8}}


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("pins the behaviour of a machine without a GPU")


def test_model_without_device_raises(no_gpu):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2LMHeadModel(TINY)


def test_init_inference_without_device_raises(no_gpu):
    model = GPT2LMHeadModel(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model=model, config=BLOCK)
    engine = deepspeed_tpu_torch.init_inference(
        model=model, config=BLOCK, device="cpu"
    )
    try:
        assert engine.device.type == "cpu"
    finally:
        engine.close()


def test_kv_pool_without_device_raises(no_gpu):
    with pytest.raises(RuntimeError):
        init_kv_pool(TINY, 4, 8)


def test_flash_fwd_cuda_entry_point_does_not_run_on_cpu(no_gpu):
    q = torch.zeros(1, 1, 256, 64)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        attention._flash_fwd_cuda(q, q, q, None, True, 0.125)
    with pytest.raises(RuntimeError):
        kernel_lib.load("flash_fwd")
    assert attention.flash_fwd.launches == 0


def test_paged_decode_cuda_entry_point_does_not_run_on_cpu(no_gpu):
    q = torch.zeros(2, 4, 64)
    pool = torch.zeros(5, 8, 4, 64)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        decode_attention._paged_decode_cuda(q, pool, pool, tables, pos, 0.125)
    with pytest.raises(RuntimeError):
        kernel_lib.load("paged_decode")
    assert decode_attention.paged_flash_decode.launches == 0


def test_initialize_without_device_raises(no_gpu):
    model = GPT2LMHeadModel(TINY, device="cpu")
    cfg = {"train_batch_size": 2}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config_params=cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config_params=cfg, device="cpu"
    )
    assert engine.device.type == "cpu"


def test_flash_bwd_cuda_entry_points_do_not_run_on_cpu(no_gpu):
    q = torch.zeros(1, 1, 256, 64)
    lse = torch.zeros(1, 1, 256)
    for which in ("dq", "dkv"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            attention._flash_bwd_cuda(which, q, q, q, None, q, lse, lse,
                                      True, 0.125, 0.1, 3)
    with pytest.raises(RuntimeError):
        kernel_lib.load("flash_bwd")
    assert attention.flash_bwd_dq.launches == 0
    assert attention.flash_bwd_dkv.launches == 0


def test_lamb_phase1_cuda_entry_point_does_not_run_on_cpu(no_gpu):
    p = [torch.zeros(10)]
    with pytest.raises(RuntimeError, match="needs every tensor"):
        fused_lamb._lamb_phase1_cuda(
            p, p, p, p, p, 1.0, 1.0, 1.0, b1=0.9, b2=0.999, eps=1e-8,
            weight_decay=0.0, eps_inside_sqrt=False,
        )
    with pytest.raises(RuntimeError):
        kernel_lib.load("lamb_phase1")
    assert fused_lamb.lamb_phase1.launches == 0
