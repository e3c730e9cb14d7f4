"""Port parity for the training slice's numerics: the LAMB phase-1 kernel's
plain version, Adam, Lamb and FusedLamb, the loss scaler, the LR
schedules, the gradient numerics and the blocked LM-head cross-entropy,
each against its JAX counterpart on the same numpy inputs (the Pallas
LAMB kernel in interpret mode, as the JAX package's own tests run it).

Tolerances (float32): the LAMB kernel and the optimizers atol = rtol =
1e-6 (the same elementwise float32 arithmetic; only the norms' sums run
in another order); the cross-entropy 1e-5 (a log-sum-exp over the vocab
in another order); the loss scaler and the schedules exactly equal (host
arithmetic on the same numbers).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu.ops import pallas as jpallas
from deepspeed_tpu.runtime import lr_schedules as jsched
from deepspeed_tpu.runtime import precision as jprec
from deepspeed_tpu.utils import numerics as jnum
from deepspeed_tpu_torch.ops import cross_entropy as tce
from deepspeed_tpu_torch.ops import fused_lamb as tfl
from deepspeed_tpu_torch.ops import optimizers as topt
from deepspeed_tpu_torch.runtime import lr_schedules as tsched
from deepspeed_tpu_torch.runtime import precision as tprec
from deepspeed_tpu_torch.utils import numerics as tnum
from torch_test_env import jax_compile_cache  # noqa: F401

jce = importlib.import_module("deepspeed_tpu.ops.cross_entropy")

TOL = dict(atol=1e-6, rtol=1e-6)
CE_TOL = dict(atol=1e-5, rtol=1e-5)
LAMB_KW = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
               min_coeff=0.01, max_coeff=10.0)


def _rng_arrays(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _t(xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


# ---------------------------------------------------------------------------
# the LAMB phase-1 kernel at both of its launch sites
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1000, 40_000, 70_000])
@pytest.mark.parametrize("eps_inside_sqrt", [False, True])
def test_lamb_leaf_update_matches_jax_kernel(n, eps_inside_sqrt):
    p, g, m = _rng_arrays(n, [(n,)] * 3, scale=0.1)
    v = np.abs(_rng_arrays(n + 1, [(n,)], scale=0.01)[0])
    c1, c2, lr = 0.271, 0.00299, 1e-3
    kw = dict(LAMB_KW, eps_inside_sqrt=eps_inside_sqrt)
    pj, mj, vj, rj = jpallas.lamb_leaf_update(
        *(jnp.asarray(x) for x in (p, g, m, v)), c1, c2, lr, **kw)
    ps, gs, ms, vs = (_t([x]) for x in (p, g, m, v))
    us = [torch.empty_like(ps[0])]
    ratio = tfl.lamb_leaf_update(ps, gs, ms, vs, us, c1, c2, lr, **kw)
    np.testing.assert_allclose(float(ratio), float(rj), **TOL)
    for got, want in ((ps, pj), (ms, mj), (vs, vj)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want), **TOL)


def test_lamb_multi_tensor_update_matches_jax_kernel():
    """Three leaves (1000, 40 000 and 70 000 elements, two of them not a
    whole number of blocks) in one launch: per-leaf ratios, params and
    moments as the JAX packed kernel gives them."""
    shapes = [(10, 100), (40_000,), (70, 1000)]
    ps, gs, ms = (_rng_arrays(s, shapes, 0.1) for s in (1, 2, 3))
    vs = [np.abs(x) for x in _rng_arrays(4, shapes, 0.01)]
    c1, c2, lr = 0.19, 0.002, 3e-3
    kw = dict(LAMB_KW, eps_inside_sqrt=False)
    pj, mj, vj, rj = jpallas.lamb_multi_tensor_update(
        *([jnp.asarray(x) for x in xs] for xs in (ps, gs, ms, vs)),
        c1, c2, lr, **kw)
    tp, tg, tm, tv = ([[t] for t in _t(xs)] for xs in (ps, gs, ms, vs))
    tu = [[torch.empty_like(grp[0])] for grp in tp]
    ratios = tfl.lamb_multi_tensor_update(tp, tg, tm, tv, tu, c1, c2, lr,
                                          **kw)
    np.testing.assert_allclose([float(r) for r in ratios],
                               [float(r) for r in rj], **TOL)
    for got, want in ((tp, pj), (tm, mj), (tv, vj)):
        for grp, w in zip(got, want):
            np.testing.assert_allclose(grp[0].numpy(), np.asarray(w), **TOL)


def test_lamb_phase1_partials_are_per_block_sums():
    """The plain version returns one p*p and one u*u partial per
    BLOCK-element block of each tensor, in list order."""
    p = [torch.ones(tfl.BLOCK + 5), torch.full((3,), 2.0)]
    z = [torch.zeros_like(t) for t in p]
    wsq, usq = tfl.lamb_phase1(
        p, z, [t.clone() for t in z], [t.clone() for t in z],
        [torch.empty_like(t) for t in p], 1.0, 1.0, b1=0.9, b2=0.999,
        eps=1e-8, weight_decay=0.0, eps_inside_sqrt=False)
    np.testing.assert_array_equal(wsq.numpy(), [tfl.BLOCK, 5.0, 12.0])
    np.testing.assert_array_equal(usq.numpy(), [0.0, 0.0, 0.0])


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------
SHAPES = {"a": (40, 50), "b": (300,), "c": (70, 1000)}


def _lamb_lists(sizes, base=None):
    """p, g, m, v, u lists of float32 tensors of ``sizes``; with ``base``
    (a 1-D tensor) p is cut from it as views."""
    if base is not None:
        ps, at = [], 0
        for n in sizes:
            ps.append(base[at:at + n])
            at += n
    else:
        ps = [torch.zeros(n) for n in sizes]
    return [ps] + [[torch.zeros(n) for n in sizes] for _ in range(4)]


def test_lamb_device_table_block_map_and_cache():
    """The kernel's descriptor table and int32 block -> tensor map (no
    search in the kernel): each tensor's n, first block and vector flag,
    one map entry per 4096-element block; built once per set of pointers
    and lengths and reused, rebuilt when a pointer or a length changes."""
    sizes = [1, 3, 4096, 4097, 4099, 8192]
    lists = _lamb_lists(sizes)
    device = torch.device("cpu")
    builds = tfl.lamb_phase1.table_builds
    table, block_map, nblocks = tfl._device_table(*lists, device)
    assert tfl.lamb_phase1.table_builds == builds + 1
    blocks = [1, 1, 1, 2, 2, 2]
    assert nblocks == sum(blocks) == block_map.numel()
    assert block_map.dtype == torch.int32
    assert block_map.tolist() == [i for i, n in enumerate(blocks)
                                  for _ in range(n)]
    rows = table.numpy()
    assert rows.shape == (len(sizes), 8)
    assert rows[:, 5].tolist() == sizes
    assert rows[:, 6].tolist() == [0, 1, 2, 3, 5, 7]
    for row, (p, g, m, v, u) in zip(rows, zip(*lists)):
        assert row[:5].tolist() == [t.data_ptr() for t in (p, g, m, v, u)]
    # vectors only where n % 4 == 0 and every pointer is aligned
    aligned = [all(t.data_ptr() % 16 == 0 for t in ts) for ts in zip(*lists)]
    assert rows[:, 7].tolist() == [
        int(n % 4 == 0 and ok) for n, ok in zip(sizes, aligned)]
    # the same tensors: the cached table, nothing built
    again = tfl._device_table(*lists, device)
    assert again[0] is table and again[1] is block_map
    assert tfl.lamb_phase1.table_builds == builds + 1
    # a moved tensor (new storage) or another length: rebuilt
    lists[1][2] = torch.zeros(4096)
    tfl._device_table(*lists, device)
    assert tfl.lamb_phase1.table_builds == builds + 2
    lists[0][5], lists[2][5] = lists[0][5][:8000], lists[2][5][:8000]
    lists[1][5], lists[3][5] = lists[1][5][:8000], lists[3][5][:8000]
    lists[4][5] = lists[4][5][:8000]
    _, _, n2 = tfl._device_table(*lists, device)
    assert tfl.lamb_phase1.table_builds == builds + 3 and n2 == nblocks


def test_lamb_device_table_flags_a_misaligned_view_scalar():
    """A view whose storage offset breaks 16-byte alignment goes down the
    kernel's scalar path (its descriptor's flag), decided per tensor."""
    base = torch.zeros(4096 * 3 + 1)
    lists = _lamb_lists([4096, 4096], base=base[1:])  # 4 bytes off
    aligned = _lamb_lists([4096, 4096])
    for i in range(1, 5):
        lists[i] = aligned[i]
    table, _, _ = tfl._device_table(*lists, torch.device("cpu"))
    assert table.numpy()[:, 7].tolist() == [0, 0]
    table, _, _ = tfl._device_table(*aligned, torch.device("cpu"))
    if all(t.data_ptr() % 16 == 0 for ts in aligned for t in ts):
        assert table.numpy()[:, 7].tolist() == [1, 1]


def test_lamb_segment_map_is_built_once_per_layout():
    builds = tfl.lamb_phase1.table_builds
    device = torch.device("cpu")
    seg = tfl._segment_map([2, 1, 3], [0, 0, 1], device)
    # each group's block positions, padded past the last block
    assert seg.tolist() == [[0, 1, 2], [3, 4, 5]]
    assert tfl._segment_map([2, 1, 3], [0, 0, 1], device) is seg
    assert tfl.lamb_phase1.table_builds == builds + 1
    assert tfl._segment_map([2, 1, 4], [0, 0, 1], device).tolist() == [
        [0, 1, 2, 7], [3, 4, 5, 6]]
    assert tfl.lamb_phase1.table_builds == builds + 2


def _jax_tree(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def _run_both(jax_opt, port_opt, steps=3, grad_scale=0.5, mom=None):
    """``steps`` updates of both optimizers from the same params and
    grads; yields (jax params, jax state, jax aux, port params, port
    state, port aux) after each."""
    params = dict(zip(SHAPES, _rng_arrays(0, SHAPES.values(), 0.2)))
    jp, tp = _jax_tree(params), {k: torch.from_numpy(v.copy())
                                 for k, v in params.items()}
    js, ts = jax_opt.init(jp), port_opt.init(tp)
    for step in range(steps):
        grads = dict(zip(SHAPES, _rng_arrays(10 + step, SHAPES.values(),
                                             0.05)))
        kw = {} if mom is None else {"mom": mom}
        jp, js, jaux = jax_opt.apply(jp, _jax_tree(grads), js, 1e-3,
                                     grad_scale=grad_scale, **kw)
        taux = port_opt.apply(tp, {k: torch.from_numpy(v)
                                   for k, v in grads.items()}, ts, 1e-3,
                              grad_scale=grad_scale, **kw)
        yield jp, js, jaux, tp, ts, taux


def _assert_state(jp, js, tp, ts):
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL)
        np.testing.assert_allclose(ts["mu"][k].numpy(),
                                   np.asarray(js["mu"][k]), **TOL)
        np.testing.assert_allclose(ts["nu"][k].numpy(),
                                   np.asarray(js["nu"][k]), **TOL)
    assert ts["step"] == int(js["step"])


@pytest.mark.parametrize("kw", [
    dict(), dict(weight_decay=0.01), dict(weight_decay=0.01,
                                          adam_w_mode=False),
    dict(bias_correction=False, b1=0.8, b2=0.99, eps=1e-6),
])
def test_adam_matches_jax(kw):
    for jp, js, _, tp, ts, taux in _run_both(jopt.Adam(**kw),
                                             topt.Adam(**kw)):
        _assert_state(jp, js, tp, ts)
        assert taux == {}


@pytest.mark.parametrize("cls_j,cls_t,kw", [
    (jopt.Lamb, topt.Lamb, dict(weight_decay=0.01)),
    (jopt.Lamb, topt.Lamb, dict(eps_inside_sqrt=True, max_coeff=0.5)),
    (jpallas.FusedLamb, tfl.FusedLamb, dict(weight_decay=0.01)),
    (jpallas.FusedLamb, tfl.FusedLamb,
     dict(eps_inside_sqrt=True, max_coeff=0.5)),
    # "c" (70 000 elements) gets a launch of its own, a and b share one
    (jpallas.FusedLamb, tfl.FusedLamb, dict(multi_tensor_max=5000)),
])
def test_lamb_and_fused_lamb_match_jax(cls_j, cls_t, kw):
    for jp, js, jaux, tp, ts, taux in _run_both(cls_j(**kw), cls_t(**kw)):
        _assert_state(jp, js, tp, ts)
        np.testing.assert_allclose(
            [float(c) for c in taux["lamb_coeffs"]],
            [float(c) for c in jaux["lamb_coeffs"]], **TOL)


def test_lamb_momentum_override_matches_jax():
    for jp, js, jaux, tp, ts, taux in _run_both(jopt.Lamb(), topt.Lamb(),
                                                mom=0.85):
        _assert_state(jp, js, tp, ts)


def test_lamb_groups_the_layers_of_a_stacked_leaf():
    """The JAX GPT-2 stacks each block parameter over the layers, so its
    LAMB takes one trust ratio per stacked leaf; the port keeps one tensor
    per layer and groups ``h.<i>.<name>`` into ``h.*.<name>``."""
    layers = _rng_arrays(5, [(30, 20)] * 3, 0.3)
    grads = _rng_arrays(6, [(30, 20)] * 3, 0.05)
    wte, gwte = _rng_arrays(7, [(50, 20), (50, 20)], 0.1)
    jparams = {"h": {"w": jnp.asarray(np.stack(layers))},
               "wte": jnp.asarray(wte)}
    jgrads = {"h": {"w": jnp.asarray(np.stack(grads))},
              "wte": jnp.asarray(gwte)}
    jo = jopt.Lamb(weight_decay=0.01)
    jp, _, jaux = jo.apply(jparams, jgrads, jo.init(jparams), 1e-2)
    tparams = {f"h.{i}.w": torch.from_numpy(x.copy())
               for i, x in enumerate(layers)}
    tparams["wte"] = torch.from_numpy(wte.copy())
    tgrads = {f"h.{i}.w": torch.from_numpy(x) for i, x in enumerate(grads)}
    tgrads["wte"] = torch.from_numpy(gwte)
    assert list(topt.param_groups(tparams)) == ["h.*.w", "wte"]
    to = topt.Lamb(weight_decay=0.01)
    taux = to.apply(tparams, tgrads, to.init(tparams), 1e-2)
    np.testing.assert_allclose([float(c) for c in taux["lamb_coeffs"]],
                               [float(c) for c in jaux["lamb_coeffs"]], **TOL)
    for i in range(3):
        np.testing.assert_allclose(tparams[f"h.{i}.w"].numpy(),
                                   np.asarray(jp["h"]["w"][i]), **TOL)


@pytest.mark.parametrize("name,params", [
    ("Adam", {"lr": 1e-3, "betas": [0.8, 0.9], "weight_decay": 0.1}),
    ("AdamW", {"lr": 1e-3, "max_grad_norm": 1.0}),
    ("Lamb", {"lr": 1e-3, "max_coeff": 3.0}),
    ("FusedLamb", {"lr": 1e-3, "min_coeff": 0.1}),
])
def test_build_optimizer_matches_jax(name, params):
    j = jopt.build_optimizer(name, params)
    t = topt.build_optimizer(name, params)
    assert type(t).__name__ == type(j).__name__
    for field in ("b1", "b2", "eps", "weight_decay", "bias_correction",
                  "adam_w_mode", "max_coeff", "min_coeff"):
        assert getattr(t, field, None) == getattr(j, field, None)


# ---------------------------------------------------------------------------
# loss scaling, LR schedules, gradient numerics
# ---------------------------------------------------------------------------
OVERFLOWS = [True, False, False, True, True, False, False, False, True,
             False, False, False, False, True, True, True]


@pytest.mark.parametrize("make", [
    lambda m: m.dynamic_loss_scale_state(init_scale=2.0**16, scale_window=3,
                                         delayed_shift=2, min_scale=2.0**14),
    lambda m: m.dynamic_loss_scale_state(init_scale=2.0**10, scale_window=2,
                                         delayed_shift=3,
                                         consecutive_hysteresis=True),
    lambda m: m.static_loss_scale_state(128.0),
    lambda m: m.no_loss_scale_state(),
])
def test_loss_scale_schedule_matches_jax(make):
    js, ts = make(jprec), make(tprec)
    for overflow in OVERFLOWS:
        js = jprec.update_scale(js, jnp.asarray(overflow))
        ts = tprec.update_scale(ts, overflow)
        assert ts.loss_scale == float(js.loss_scale)
        assert ts.good_steps == int(js.good_steps)
        assert ts.hysteresis == int(js.hysteresis)


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 3,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 3,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 5, "decay_step_size": 2,
                  "decay_lr_rate": 0.1, "decay_mom_rate": 0.05}),
    ("WarmupLR", {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 7}),
    ("WarmupDecayLR", {"warmup_max_lr": 1e-3, "warmup_num_steps": 5,
                       "total_num_steps": 20}),
])
def test_lr_schedules_match_jax(name, params):
    j = jsched.build_lr_scheduler(name, dict(params))
    t = tsched.build_lr_scheduler(name, dict(params))
    for _ in range(25):
        assert t.get_lr() == j.get_lr()
        if hasattr(j, "get_mom"):
            assert t.get_mom() == j.get_mom()
        j.step()
        t.step()
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("poison", [None, np.inf, np.nan])
@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
def test_gradient_numerics_match_jax(poison, norm_type):
    xs = _rng_arrays(3, [(7, 9), (100,), (3, 4, 5)], 2.0)
    if poison is not None:
        xs[1][17] = poison
    jn = jnum.global_norm([jnp.asarray(x) for x in xs], norm_type)
    tn = tnum.global_norm(_t(xs), norm_type)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    if poison is not None:
        assert float(tn) == -1.0
    assert bool(tnum.has_overflow(_t(xs))) == bool(
        jnum.has_overflow([jnp.asarray(x) for x in xs]))
    if poison is None and norm_type == 2.0:
        jc, _ = jnum.clip_by_global_norm([jnp.asarray(x) for x in xs], 1.5)
        tc, _ = tnum.clip_by_global_norm(_t(xs), 1.5)
        for got, want in zip(tc, jc):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("t,block", [(37, 16), (64, 64), (40, 512)])
def test_blocked_lm_head_loss_matches_jax(t, block):
    """The loss and its gradients in hidden and the tied table, with
    ignored labels and a last chunk shorter than the block."""
    b, h, v = 2, 16, 50
    hidden, table = _rng_arrays(8, [(b, t, h), (v, h)], 0.5)
    labels = np.random.default_rng(9).integers(0, v, (b, t)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, 3] = -1

    def jax_loss(x, w):
        return jce.blocked_lm_head_loss(x, w, jnp.asarray(labels),
                                        block_rows=block)

    jl, (jgx, jgw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(table))
    x = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(table).requires_grad_()
    tl = tce.blocked_lm_head_loss(x, w, torch.from_numpy(labels).long(),
                                  block_rows=block)
    tgx, tgw = torch.autograd.grad(tl, (x, w))
    np.testing.assert_allclose(float(tl), float(jl), **CE_TOL)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), **CE_TOL)
    np.testing.assert_allclose(tgw.numpy(), np.asarray(jgw), **CE_TOL)
    plain = tce.cross_entropy_ignore_index(
        torch.from_numpy(hidden) @ torch.from_numpy(table).t(),
        torch.from_numpy(labels).long())
    np.testing.assert_allclose(float(plain), float(jl), **CE_TOL)
