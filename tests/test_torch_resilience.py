"""Port parity for the pure resilience modules (resilience/): the JAX
package's module tests run against BOTH packages through the ``pkg``
parametrization, and the cross-package tests hold the two to the same
retry delays, manifest verdicts, tag order, pruning choice, fault fire
indices, ``mangle_line`` bytes and config rejections (the same key named
in the same error text) on the same inputs.

No engine is built here; tests/test_torch_checkpointing.py drives the
engines.
"""

import importlib
import json
import os
import signal
import types

import numpy as np
import pytest
from torch_test_env import jax_compile_cache  # noqa: F401

PACKAGES = ("deepspeed_tpu", "deepspeed_tpu_torch")


def _load(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    cfg = mod("config.config")
    return types.SimpleNamespace(
        root=root,
        atomic_io=mod("resilience.atomic_io"),
        manifest=mod("resilience.manifest"),
        retention=mod("resilience.retention"),
        preemption=mod("resilience.preemption"),
        faults=mod("resilience.faults"),
        supervisor=mod("resilience.supervisor"),
        manager=mod("resilience.manager"),
        resilience=mod("resilience"),
        registry=mod("telemetry.registry"),
        watchdog=mod("telemetry.watchdog"),
        DeepSpeedConfig=cfg.DeepSpeedConfig,
        DeepSpeedConfigError=cfg.DeepSpeedConfigError,
    )


@pytest.fixture(params=PACKAGES, ids=("jax", "torch"))
def pkg(request):
    return _load(request.param)


@pytest.fixture(scope="module")
def both():
    return [_load(root) for root in PACKAGES]


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------
def test_retry_policy_validation(pkg):
    RetryPolicy = pkg.atomic_io.RetryPolicy
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(backoff_base=0)
    with pytest.raises(ValueError):
        RetryPolicy(jitter=1.5)


def test_retry_policy_delay_doubles_and_caps(pkg):
    p = pkg.atomic_io.RetryPolicy(max_attempts=5, backoff_base=1.0,
                                  backoff_max=3.0, jitter=0)
    assert [p.delay(k) for k in (1, 2, 3, 4)] == [1.0, 2.0, 3.0, 3.0]


def test_retry_delays_agree_across_packages(both):
    """Same policy, same draw of the jitter source: the same delays."""
    import random

    delays = []
    for p in both:
        policy = p.atomic_io.RetryPolicy(max_attempts=6, backoff_base=0.05,
                                         backoff_max=0.5, jitter=0.25)
        random.seed(1234)
        delays.append([policy.delay(k) for k in range(1, 7)])
    assert delays[0] == delays[1]


def test_with_retries_recovers_from_transient_oserror(pkg):
    calls = {"n": 0}
    retries = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    result = pkg.atomic_io.with_retries(
        flaky,
        policy=pkg.atomic_io.RetryPolicy(max_attempts=3, backoff_base=0.001),
        on_retry=lambda op, attempt, e: retries.append(attempt),
        sleep=lambda s: None,
    )
    assert result == "ok" and retries == [1, 2]


def test_with_retries_exhausts_and_reraises(pkg):
    def always_fails():
        raise OSError("dead mount")

    with pytest.raises(OSError):
        pkg.atomic_io.with_retries(
            always_fails,
            policy=pkg.atomic_io.RetryPolicy(max_attempts=2,
                                             backoff_base=0.001),
            sleep=lambda s: None,
        )


@pytest.mark.parametrize("kind", ["parse", "corruption"])
def test_with_retries_does_not_retry_corruption(pkg, kind):
    calls = {"n": 0}
    exc = (ValueError("truncated file") if kind == "parse" else
           pkg.manifest.CheckpointCorruptionError("sha256 mismatch"))

    def broken():
        calls["n"] += 1
        raise exc

    with pytest.raises(type(exc)):
        pkg.atomic_io.with_retries(
            broken, policy=pkg.atomic_io.RetryPolicy(max_attempts=5))
    assert calls["n"] == 1  # corruption is not transient


# ---------------------------------------------------------------------------
# atomic writes
# ---------------------------------------------------------------------------
def test_atomic_write_roundtrip_no_temp_leftover(pkg, tmp_path):
    path = tmp_path / "f.bin"
    pkg.atomic_io.atomic_write_bytes(str(path), b"payload")
    assert path.read_bytes() == b"payload"
    assert [p.name for p in tmp_path.iterdir()] == ["f.bin"]


def test_atomic_write_crash_preserves_old_content(pkg, tmp_path,
                                                  monkeypatch):
    path = tmp_path / "f.bin"
    pkg.atomic_io.atomic_write_bytes(str(path), b"old")

    def crash(src, dst):
        raise OSError("killed mid-publish")

    monkeypatch.setattr(pkg.atomic_io.os, "replace", crash)
    with pytest.raises(OSError):
        pkg.atomic_io.atomic_write_bytes(str(path), b"never-published")
    monkeypatch.undo()
    assert path.read_bytes() == b"old"
    assert [p.name for p in tmp_path.iterdir()] == ["f.bin"]


# ---------------------------------------------------------------------------
# manifest verdicts
# ---------------------------------------------------------------------------
MODEL = "mp_rank_00_model_states.pt"
OPTIM = "zero_pp_rank_0_mp_rank_00optim_states.pt"


def _fake_checkpoint(manifest, dirpath, tag="t", steps=5):
    os.makedirs(dirpath, exist_ok=True)
    for name, blob in ((MODEL, b"model" * 100), (OPTIM, b"optim" * 100)):
        with open(os.path.join(dirpath, name), "wb") as f:
            f.write(blob)
    manifest.write_manifest(dirpath, tag, meta={"global_steps": steps})


def test_manifest_verify_valid(pkg, tmp_path):
    d = str(tmp_path / "t")
    _fake_checkpoint(pkg.manifest, d)
    status, reason = pkg.manifest.verify_checkpoint(d)
    assert status == pkg.manifest.VALID, reason
    m = json.load(open(os.path.join(d, pkg.manifest.MANIFEST_FILE)))
    assert set(m["files"]) == {MODEL, OPTIM}
    assert m["global_steps"] == 5 and m["format_version"] == 1


def test_manifest_detects_truncation_and_bitflips(pkg, tmp_path):
    d = str(tmp_path / "t")
    _fake_checkpoint(pkg.manifest, d)
    f = os.path.join(d, MODEL)
    blob = open(f, "rb").read()
    open(f, "wb").write(blob[: len(blob) // 2])
    status, reason = pkg.manifest.verify_checkpoint(d)
    assert status == pkg.manifest.CORRUPT and "size" in reason
    open(f, "wb").write(bytes([blob[0] ^ 0xFF]) + blob[1:])
    status, reason = pkg.manifest.verify_checkpoint(d)
    assert status == pkg.manifest.CORRUPT and "sha256" in reason
    assert pkg.manifest.verify_checkpoint(d, deep=False)[0] == \
        pkg.manifest.VALID


def test_manifest_detects_missing_file(pkg, tmp_path):
    d = str(tmp_path / "t")
    _fake_checkpoint(pkg.manifest, d)
    os.unlink(os.path.join(d, OPTIM))
    status, reason = pkg.manifest.verify_checkpoint(d)
    assert status == pkg.manifest.CORRUPT and "missing" in reason


def test_manifest_legacy_and_missing_verdicts(pkg, tmp_path):
    m = pkg.manifest
    d = str(tmp_path / "legacy")
    _fake_checkpoint(m, d)
    os.unlink(os.path.join(d, m.MANIFEST_FILE))
    assert m.verify_checkpoint(d)[0] == m.LEGACY
    assert m.verify_checkpoint(str(tmp_path / "nope"))[0] == m.MISSING
    empty = tmp_path / "empty"
    empty.mkdir()
    assert m.verify_checkpoint(str(empty))[0] == m.MISSING


def test_manifest_malformed_json_is_corrupt(pkg, tmp_path):
    d = str(tmp_path / "t")
    _fake_checkpoint(pkg.manifest, d)
    open(os.path.join(d, pkg.manifest.MANIFEST_FILE), "w").write("{not json")
    assert pkg.manifest.verify_checkpoint(d)[0] == pkg.manifest.CORRUPT


def test_ordered_tags_survives_malformed_manifest_values(pkg, tmp_path):
    m = pkg.manifest
    _fake_checkpoint(m, str(tmp_path / "good"), tag="good", steps=3)
    bad = str(tmp_path / "bad")
    _fake_checkpoint(m, bad, tag="bad", steps=1)
    doc = json.load(open(os.path.join(bad, m.MANIFEST_FILE)))
    doc["global_steps"] = None
    doc["created_unix"] = "yesterday"
    json.dump(doc, open(os.path.join(bad, m.MANIFEST_FILE), "w"))
    tags = m.ordered_tags(str(tmp_path))
    assert set(tags) == {"good", "bad"} and tags[0] == "good"


def test_ordered_tags_newest_first(pkg, tmp_path):
    for i, tag in enumerate(["a", "b", "c"]):
        _fake_checkpoint(pkg.manifest, str(tmp_path / tag), tag=tag,
                         steps=i * 10)
    (tmp_path / "latest").write_text("c")
    assert pkg.manifest.ordered_tags(str(tmp_path)) == ["c", "b", "a"]


def _verdict_matrix(tmp_path, writer):
    """Every corruption of one directory written by ``writer``'s
    manifest: ``{case: dir}``."""
    cases = {}
    for case in ("valid", "truncated", "bitflip", "missing", "nomanifest",
                 "badjson"):
        d = str(tmp_path / case)
        _fake_checkpoint(writer.manifest, d, tag=case)
        f = os.path.join(d, MODEL)
        blob = open(f, "rb").read()
        if case == "truncated":
            open(f, "wb").write(blob[:7])
        elif case == "bitflip":
            open(f, "wb").write(blob[:-1] + bytes([blob[-1] ^ 1]))
        elif case == "missing":
            os.unlink(os.path.join(d, OPTIM))
        elif case == "nomanifest":
            os.unlink(os.path.join(d, writer.manifest.MANIFEST_FILE))
        elif case == "badjson":
            open(os.path.join(d, writer.manifest.MANIFEST_FILE), "w").write(
                "[]")
        cases[case] = d
    return cases


@pytest.mark.parametrize("writer", [0, 1], ids=("jax", "torch"))
def test_manifest_verdicts_agree_across_packages(both, tmp_path, writer):
    """A manifest written by either package is judged the same by both,
    and the manifests themselves agree key for key."""
    cases = _verdict_matrix(tmp_path, both[writer])
    want = {"valid": "valid", "truncated": "corrupt", "bitflip": "corrupt",
            "missing": "corrupt", "nomanifest": "legacy",
            "badjson": "corrupt"}
    for case, d in cases.items():
        verdicts = [p.manifest.verify_checkpoint(d) for p in both]
        assert verdicts[0] == verdicts[1], case
        assert verdicts[0][0] == want[case], (case, verdicts[0])
    doc = json.load(open(os.path.join(cases["valid"], "MANIFEST.json")))
    assert sorted(doc) == ["created_unix", "files", "format_version",
                           "global_steps", "tag"]


def test_tag_order_and_pruning_agree_across_packages(both, tmp_path):
    """The same directory tree: the same tag order, and the same tags
    pruned (run on two copies, one per package)."""
    import shutil

    base = tmp_path / "base"
    for i in range(5):
        _fake_checkpoint(both[0].manifest, str(base / f"step{i}"),
                         tag=f"step{i}", steps=i)
    os.unlink(str(base / "step3" / MODEL))  # corrupt: takes no keep slot
    (base / "latest").write_text("step1")
    orders, deleted = [], []
    for i, p in enumerate(both):
        orders.append(p.manifest.ordered_tags(str(base)))
        d = tmp_path / f"copy{i}"
        shutil.copytree(base, d)
        deleted.append(sorted(p.retention.prune_checkpoints(str(d), 2)))
    assert orders[0] == orders[1] == [f"step{i}" for i in (4, 3, 2, 1, 0)]
    assert deleted[0] == deleted[1] == ["step0"]


# ---------------------------------------------------------------------------
# retention GC
# ---------------------------------------------------------------------------
def test_retention_prunes_oldest_keeps_newest(pkg, tmp_path):
    for i in range(5):
        _fake_checkpoint(pkg.manifest, str(tmp_path / f"step{i}"),
                         tag=f"step{i}", steps=i)
    (tmp_path / "latest").write_text("step4")
    deleted = pkg.retention.prune_checkpoints(str(tmp_path), keep_last_n=2)
    assert sorted(deleted) == ["step0", "step1", "step2"]
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == [
        "step3", "step4"]


def test_retention_zero_keeps_everything(pkg, tmp_path):
    for i in range(3):
        _fake_checkpoint(pkg.manifest, str(tmp_path / f"step{i}"), steps=i)
    assert pkg.retention.prune_checkpoints(str(tmp_path), keep_last_n=0) == []
    assert len(list(tmp_path.iterdir())) == 3


def test_retention_never_deletes_newest_valid_or_latest_target(pkg,
                                                               tmp_path):
    _fake_checkpoint(pkg.manifest, str(tmp_path / "good"), tag="good",
                     steps=0)
    for i, tag in enumerate(["bad1", "bad2"]):
        d = str(tmp_path / tag)
        _fake_checkpoint(pkg.manifest, d, tag=tag, steps=10 + i)
        os.unlink(os.path.join(d, MODEL))
    (tmp_path / "latest").write_text("good")
    pkg.retention.prune_checkpoints(str(tmp_path), keep_last_n=1)
    assert (tmp_path / "good").is_dir()


# ---------------------------------------------------------------------------
# preemption handler
# ---------------------------------------------------------------------------
def test_resolve_signals_rejects_unknown(pkg):
    assert pkg.preemption.resolve_signals(["SIGTERM", "SIGINT"]) == [
        signal.SIGTERM, signal.SIGINT]
    with pytest.raises(ValueError):
        pkg.preemption.resolve_signals(["SIGNOPE"])


def test_preemption_arms_on_signal_and_disarms(pkg):
    h = pkg.preemption.PreemptionHandler()
    assert not h.armed
    h._on_signal(signal.SIGTERM, None)
    assert h.armed
    h.disarm()
    assert not h.armed


def test_preemption_second_signal_exits_immediately(pkg, monkeypatch):
    h = pkg.preemption.PreemptionHandler()
    kills = []
    monkeypatch.setattr(pkg.preemption.os, "kill",
                        lambda pid, sig: kills.append((pid, sig)))
    h._on_signal(signal.SIGTERM, None)
    assert h.armed and not kills
    h._on_signal(signal.SIGTERM, None)
    assert kills == [(os.getpid(), signal.SIGTERM)]
    assert not h.armed


def test_preemption_install_uninstall_restores_disposition(pkg):
    """Under an xdist worker the disposition restored is the worker's
    own, whatever it is."""
    h = pkg.preemption.PreemptionHandler(signals=("SIGUSR1",))
    prev = signal.getsignal(signal.SIGUSR1)
    assert h.install()
    assert signal.getsignal(signal.SIGUSR1) == h._on_signal
    h.uninstall()
    assert signal.getsignal(signal.SIGUSR1) == prev


# ---------------------------------------------------------------------------
# config block
# ---------------------------------------------------------------------------
def _res_cfg(pkg, block):
    return pkg.DeepSpeedConfig(
        None, param_dict={"train_batch_size": 8, "resilience": block},
        world_size=1,
    )


def test_config_defaults(pkg):
    cfg = pkg.DeepSpeedConfig(None, param_dict={"train_batch_size": 8},
                              world_size=1)
    assert cfg.resilience_enabled is True
    assert cfg.resilience_fsync is True
    assert cfg.resilience_keep_last_n == 0
    assert cfg.resilience_retry_max_attempts == 3
    assert cfg.resilience_preemption_enabled is False
    assert cfg.resilience_preemption_signals == ["SIGTERM", "SIGINT"]
    assert cfg.resilience_supervisor_enabled is False
    assert cfg.resilience_fault_injection_faults == []


BAD_BLOCKS = [
    {"keep_last_n": -1},
    {"keep_last_n": True},
    {"retry": {"max_attempts": 0}},
    {"retry": {"backoff_base": 0}},
    {"retry": {"backoff_max": "5"}},
    {"retry": {"jitter": 2.0}},
    {"preemption": {"signals": ["SIGNOPE"]}},
    {"preemption": {"signals": "SIGTERM"}},
    {"preemption": {"tag_prefix": "a/b"}},
    {"fault_injection": {"enabled": True}},
    {"fault_injection": {"enabled": "yes", "faults": []}},
    {"fault_injection": {"seed": 1.5}},
    {"fault_injection": {"enabled": True, "faults": [{"site": "nope"}]}},
    {"fault_injection": {"enabled": True,
                         "faults": [{"site": "grads.nan", "times": -1}]}},
    {"fault_injection": {"enabled": True,
                         "faults": [{"site": "grads.nan",
                                     "probability": 2}]}},
    {"fault_injection": {"enabled": True,
                         "faults": [{"site": "rpc.send",
                                     "args": {"mode": "garble"}}]}},
    {"supervisor": {"enabled": 1}},
    {"supervisor": {"max_rollbacks": -1}},
    {"supervisor": {"nonfinite_window": 0}},
    {"supervisor": {"spike_window": 1}},
    {"supervisor": {"spike_factor": -1}},
]


@pytest.mark.parametrize("block", BAD_BLOCKS, ids=lambda b: json.dumps(b))
def test_config_rejections_agree_across_packages(both, block):
    """Each bad block is refused by both parsers with the same message,
    which names the offending key."""
    messages = []
    for p in both:
        with pytest.raises(p.DeepSpeedConfigError) as err:
            _res_cfg(p, block)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert messages[0].startswith("resilience.")


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
def test_known_fault_sites_are_the_jax_packages(both):
    jf, tf = both[0].faults, both[1].faults
    assert tf.KNOWN_FAULT_SITES == jf.KNOWN_FAULT_SITES
    assert tf._RAISES == jf._RAISES
    assert tf.RPC_FAULT_MODES == jf.RPC_FAULT_MODES


def test_fault_injector_unknown_site_rejected(pkg):
    with pytest.raises(ValueError):
        pkg.faults.FaultSpec("not.a.site")


def test_fault_injector_times_after_semantics(pkg):
    f = pkg.faults
    inj = f.FaultInjector([f.FaultSpec("grads.nan", times=2, after=3)])
    fired = [inj.fire("grads.nan") is not None for _ in range(8)]
    assert fired == [False, False, False, True, True, False, False, False]
    assert inj.injected["grads.nan"] == 2


def test_fault_injector_probability_is_seed_deterministic(pkg):
    f = pkg.faults

    def pattern(seed):
        inj = f.FaultInjector(
            [f.FaultSpec("decode.step", times=0, probability=0.5,
                         seed=seed)], seed=seed)
        return [inj.fire("decode.step") is not None for _ in range(64)]

    a = pattern(7)
    assert a == pattern(7) and any(a) and not all(a)
    assert pattern(8) != a


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_fire_indices_agree_across_packages(both, seed):
    """The per-(seed, site) generator draws the same traversals in both
    packages, for every site."""
    patterns = []
    for p in both:
        f = p.faults
        inj = f.FaultInjector(
            [f.FaultSpec(site, times=0, probability=0.3, after=2, seed=seed)
             for site in sorted(f.KNOWN_FAULT_SITES)], seed=seed)
        patterns.append({
            site: [i for i in range(50) if inj.fire(site) is not None]
            for site in sorted(f.KNOWN_FAULT_SITES)})
    assert patterns[0] == patterns[1]


def test_fault_injector_raises_site_canonical_exception(pkg):
    f = pkg.faults
    inj = f.FaultInjector([f.FaultSpec("checkpoint.write"),
                           f.FaultSpec("staging.worker")])
    with pytest.raises(OSError):
        inj.maybe_raise("checkpoint.write")
    with pytest.raises(RuntimeError):
        inj.maybe_raise("staging.worker")
    inj.maybe_raise("checkpoint.write")  # exhausted


def test_null_injector_is_inert(pkg):
    null = pkg.faults.NULL_INJECTOR
    assert null.enabled is False and null.fire("grads.nan") is None
    null.maybe_raise("checkpoint.write")


def test_injected_faults_count_on_the_shared_registry(pkg):
    reg = pkg.registry.MetricsRegistry()
    inj = pkg.faults.build_fault_injector_from_dict(
        {"enabled": True, "faults": [{"site": "step.stall", "times": 2,
                                      "args": {"duration_ms": 1}}]},
        registry=reg)
    assert inj.maybe_stall() and inj.maybe_stall() and not inj.maybe_stall()
    assert reg.snapshot()["resilience/faults_injected"] == 2


def test_mangle_line_modes(pkg):
    import time as _time

    f = pkg.faults
    line = '{"op": "submit", "id": 7}'
    inj = f.FaultInjector(
        [f.FaultSpec("rpc.send", times=1, args={"mode": "drop"})])
    assert inj.mangle_line("rpc.send", line) is None
    assert inj.mangle_line("rpc.send", line) == line
    inj = f.FaultInjector(
        [f.FaultSpec("rpc.send", times=1, args={"mode": "corrupt"})])
    corrupted = inj.mangle_line("rpc.send", line)
    assert corrupted != line
    with pytest.raises(ValueError):
        json.loads(corrupted)
    inj = f.FaultInjector([f.FaultSpec(
        "rpc.recv", times=1, args={"mode": "delay", "delay_ms": 20})])
    t0 = _time.monotonic()
    assert inj.mangle_line("rpc.recv", line) == line
    assert _time.monotonic() - t0 >= 0.018
    inj = f.FaultInjector(
        [f.FaultSpec("rpc.send", times=1, args={"mode": "zap"})])
    with pytest.raises(ValueError, match="unknown rpc fault mode"):
        inj.mangle_line("rpc.send", line)


def test_mangle_line_bytes_agree_across_packages(both):
    """Probabilistic drop/corrupt over 40 lines: the same lines dropped,
    and the same bytes for each corrupted one."""
    outs = []
    for p in both:
        f = p.faults
        inj = f.FaultInjector(
            [f.FaultSpec("rpc.recv", times=0, probability=0.4,
                         args={"mode": "corrupt"}, seed=11),
             f.FaultSpec("rpc.send", times=0, probability=0.4,
                         args={"mode": "drop"}, seed=11)], seed=11)
        outs.append([(inj.mangle_line("rpc.recv", f'{{"line": {i}}}'),
                      inj.mangle_line("rpc.send", f"line-{i}"))
                     for i in range(40)])
    assert outs[0] == outs[1]
    assert any(r is None for _, r in outs[0])
    assert any(c is not None and c.endswith('#CHAOS-CORRUPT#{"')
               for c, _ in outs[0])


def test_build_fault_injector_from_dict(pkg):
    f = pkg.faults
    assert f.build_fault_injector_from_dict(None) is f.NULL_INJECTOR
    assert f.build_fault_injector_from_dict({"enabled": False}) is \
        f.NULL_INJECTOR
    assert f.build_fault_injector_from_dict(
        {"enabled": True, "faults": []}) is f.NULL_INJECTOR
    inj = f.build_fault_injector_from_dict({
        "enabled": True, "seed": 3,
        "faults": [{"site": "replica.hang", "times": 2,
                    "args": {"duration_ms": 5}}]})
    assert inj.enabled
    assert [inj.maybe_stall("replica.hang") for _ in range(3)] == [
        True, True, False]


# ---------------------------------------------------------------------------
# the manager, the supervisor, the watchdog hook
# ---------------------------------------------------------------------------
def test_manager_registers_the_six_streams(pkg):
    m = pkg.manager.ResilienceManager()
    snap = m.registry.snapshot()
    for name in ("io_retries", "corruption_fallbacks", "preemption_saves",
                 "checkpoints_pruned"):
        assert snap[f"resilience/{name}"] == 0
    assert "resilience/save_time_ms/count" in snap
    assert m.faults is pkg.faults.NULL_INJECTOR


def test_build_resilience_shares_the_registry_and_arms_faults(pkg):
    reg = pkg.registry.MetricsRegistry()
    cfg = _res_cfg(pkg, {"keep_last_n": 3, "fault_injection": {
        "enabled": True, "faults": [{"site": "checkpoint.write"}]}})
    m = pkg.manager.build_resilience(
        cfg, telemetry=types.SimpleNamespace(enabled=True, registry=reg))
    assert m.registry is reg and m.keep_last_n == 3 and m.faults.enabled
    with pytest.raises(OSError):
        m.faults.maybe_raise("checkpoint.write")
    assert reg.snapshot()["resilience/faults_injected"] == 1


def _chaos_factory(base_seed=20_000):
    def factory(start):
        def gen(i):
            while True:
                r = np.random.default_rng(base_seed + i)
                yield r.normal(size=(4, 3)).astype(np.float32)
                i += 1
        return gen(start)
    return factory


def test_replayable_source_rewinds_bitwise(pkg):
    src = pkg.supervisor.ReplayableDataSource(_chaos_factory())
    first = [next(src) for _ in range(4)]
    assert src.position == 4
    src.rewind(1)
    replay = [next(src) for _ in range(3)]
    for a, b in zip(first[1:], replay):
        np.testing.assert_array_equal(a, b)


class _FakeEngine:
    _last_grad_norm = 0.5


def test_spike_detector_triggers_rollback(pkg, monkeypatch):
    sup = pkg.supervisor.TrainingSupervisor(
        spike_factor=3.0, spike_window=8, min_history=4, nonfinite_window=10)
    calls = []
    monkeypatch.setattr(sup, "rollback",
                        lambda engine, reason: calls.append(reason))
    eng = _FakeEngine()
    for _ in range(5):
        assert sup.on_window(eng, 1.0) is False
    assert sup.on_window(eng, 10.0) is True
    assert calls and "spike" in calls[0]


def test_consecutive_nonfinite_budget(pkg, monkeypatch):
    TrainingSupervisor = pkg.supervisor.TrainingSupervisor
    sup = TrainingSupervisor(nonfinite_window=3)
    calls = []
    monkeypatch.setattr(sup, "rollback",
                        lambda engine, reason: calls.append(reason))
    eng = _FakeEngine()
    assert sup.on_window(eng, float("nan")) is False
    assert sup.on_window(eng, 1.0) is False
    assert sup.on_window(eng, float("nan")) is False
    assert sup.on_window(eng, float("inf")) is False
    assert sup.on_window(eng, float("nan")) is True
    sup2 = TrainingSupervisor(nonfinite_window=1)
    monkeypatch.setattr(sup2, "rollback",
                        lambda engine, reason: calls.append(reason))

    class Skipped:
        _last_grad_norm = -1.0

    assert sup2.on_window(Skipped(), 1.0) is True


def test_rollback_without_checkpoint_escalates_typed(pkg):
    sup = pkg.supervisor.TrainingSupervisor(nonfinite_window=1)

    class NoCheckpoint:
        _last_grad_norm = -1.0
        _last_checkpoint_dir = None

    with pytest.raises(pkg.resilience.SupervisorEscalation) as err:
        sup.on_window(NoCheckpoint(), float("nan"))
    assert "no committed checkpoint" in str(err.value)
    assert err.value.rollbacks == 0


def test_failures_the_supervisor_will_not_heal(pkg):
    sup = pkg.supervisor.TrainingSupervisor()
    ragged = RuntimeError("ran dry mid-window")
    ragged.ds_unrecoverable = True
    assert sup.on_failure(object(), ragged) is False
    assert sup.on_failure(object(), TypeError("a caller's bug")) is False


def test_watchdog_stall_listener_fires(pkg):
    clock = {"t": 0.0}
    seen = []
    wd = pkg.watchdog.StepHeartbeatWatchdog(timeout=10.0,
                                            clock=lambda: clock["t"])
    sup = pkg.supervisor.TrainingSupervisor()
    wd.add_stall_listener(lambda waited, step: seen.append((waited, step)))
    wd.add_stall_listener(sup.notify_stall)
    wd.beat(step=3)
    clock["t"] = 11.0
    assert wd.check() is True
    assert seen and seen[0][1] == 3 and sup._stalled.is_set()


def test_the_port_exports_the_jax_packages_names(both):
    assert sorted(both[1].resilience.__all__) == sorted(
        both[0].resilience.__all__)
