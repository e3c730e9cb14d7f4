"""Row-sparse (CSR) gradients (runtime/sparse.py), after
tests/unit/test_csr.py.

In this process: the CSR round trip and its size accounting against the
JAX package's CSRTensor on the same rows. Across 2 gloo ranks: the
sparse all-reduce (an all-gather of each rank's fixed-capacity indices
and values, then an index-add) equals the dense sum of every rank's
gradient, and the engine's ``sparse_gradients`` (GPT-2's ``wte`` lookup
through the sparse path) trains as the dense run does: losses and
parameters after 5 windows to the ZeRO parity tolerance, ``rtol=2e-4,
atol=1e-5`` (the same gradient, summed in another order), at stages 0
and 2.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_dp_ranks as ranks
from deepspeed_tpu.runtime.sparse import CSRTensor as JCSRTensor
from deepspeed_tpu_torch.runtime.sparse import (
    CSRTensor,
    sparse_embedding_lookup,
)
from torch_test_env import jax_compile_cache  # noqa: F401

TOL = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = {"kind": "train", "model": "gpt2", "steps": 5, "accum": 2,
            "micro": 2, "lr": 1e-4, "opt": "Adam", "dtype": "fp32"}
    cases = [{"name": "sparse-k4", "kind": "sparse", "max_rows": 4},
             {"name": "sparse-k12", "kind": "sparse", "max_rows": 12}]
    for stage in (0, 2):
        cases += [dict(base, name=f"dense-s{stage}", stage=stage),
                  dict(base, name=f"csr-s{stage}", stage=stage,
                       extra={"sparse_gradients": True})]
    work = tmp_path_factory.mktemp("sparse")
    return ranks.finish(ranks.start(2, cases, work), timeout=120)


@pytest.mark.parametrize("max_rows", [4, 7, None])
def test_csr_round_trip_matches_jax(max_rows):
    dense = ranks.sparse_rows(0)
    got = CSRTensor.from_dense(torch.from_numpy(dense), max_rows=max_rows)
    want = JCSRTensor.from_dense(jnp.asarray(dense), max_rows=max_rows)
    np.testing.assert_array_equal(got.to_dense().numpy(), dense)
    np.testing.assert_array_equal(np.asarray(want.to_dense()), dense)
    assert got.sparse_size() == want.sparse_size()
    assert got.type() == JCSRTensor.type() == "deepspeed.CSRTensor"
    assert "reduction_factor" in repr(got)


def test_csr_add_concatenates_and_densifies_to_the_sum():
    a, b = ranks.sparse_rows(0), ranks.sparse_rows(1)
    csr = CSRTensor.from_dense(torch.from_numpy(a))
    csr.add(CSRTensor.from_dense(torch.from_numpy(b)))
    np.testing.assert_allclose(csr.to_dense().numpy(), a + b, rtol=1e-6)
    with pytest.raises(ValueError, match="dense sizes"):
        csr.add(CSRTensor.from_dense(torch.zeros(3, 5)))


@pytest.mark.parametrize("k", [4, 12])
def test_sparse_all_reduce_equals_the_dense_sum(runs, k):
    want = ranks.sparse_rows(0) + ranks.sparse_rows(1)
    for r in runs:
        np.testing.assert_allclose(r[f"sparse-k{k}"]["dense"], want,
                                   rtol=1e-6, atol=1e-7)


def test_one_process_lookup_is_the_plain_gather():
    table = torch.randn(6, 3, requires_grad=True)
    ids = torch.tensor([[0, 2, 2], [5, 0, 1]])
    out = sparse_embedding_lookup(table, ids)
    out.sum().backward()
    assert torch.equal(out, table[ids])
    assert table.grad[2].eq(2).all() and table.grad[3].eq(0).all()


@pytest.mark.parametrize("stage", [0, 2])
def test_sparse_gradients_train_as_the_dense_run(runs, stage):
    dense, csr = runs[0][f"dense-s{stage}"], runs[0][f"csr-s{stage}"]
    np.testing.assert_allclose(csr["losses"], dense["losses"], **TOL)
    for n, want in dense["params"].items():
        np.testing.assert_allclose(csr["params"][n], want, err_msg=n, **TOL)
