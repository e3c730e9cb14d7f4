"""Adapter-pool errors the scheduler handles.

Port of the part of deepspeed_tpu/adapters/pool.py that the scheduler
imports: :class:`AdapterPoolFull`, which it catches when a deferred
request's adapter cannot be pinned yet. The engine refuses the
``adapters`` block, so the host-side pool registry itself is not ported
yet.
"""


class AdapterPoolFull(RuntimeError):
    """Every pool slot holds an adapter with live requests — nothing is
    evictable, so the load must fail loudly (or wait for traffic)."""

    def __init__(self, n_slots):
        super().__init__(
            f"adapter pool full: all {n_slots} slots hold adapters with "
            "live requests (raise adapters.pool_slots or retry when "
            "traffic drains)"
        )
