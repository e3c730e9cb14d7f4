"""Pipeline parallelism: a GPipe schedule over the mesh's ``pipe`` axis.

Port of deepspeed_tpu/parallel/pipeline.py. The JAX package runs every
stage as one SPMD program (a ``lax.scan`` of ticks under ``shard_map``,
activations hopping with ``ppermute``, and the reverse pipeline from
``jax.grad``). The port runs one process per stage: stage ``p`` computes
its microbatches in turn, receiving each one's input from stage ``p - 1``
and sending its output to stage ``p + 1`` (``isend``/``irecv`` over the
pipe process group, each hop under a tag of its own, since gloo matches a
receive by peer and tag), and the backward is the reverse schedule: each
stage keeps its microbatches' autograd graphs and, last microbatch
first, receives the gradient of a microbatch's output, runs
``torch.autograd.backward`` through that microbatch's graph and sends the
gradient of its input back. No stage ever computes a bubble tick (there
are none to mask, which is the property the JAX schedule's zeroed bubble
inputs provide), and one stage is the sequential stack.

:func:`gpipe` is ``gpipe_spmd``'s contract: ``stage_fn(local_params, x,
mb_idx, extras)`` on each of M microbatches, an optional
``last_stage_fn(y, mb_idx, extras) -> scalar`` on the last stage, and
the outputs (or the M scalars) the same on every stage. With
``broadcast=False`` the outputs stay on the last stage (the other stages
get zeros of their shape): the caller computes its loss there and
broadcasts the scalar (:func:`pipe_broadcast`), as GPT-2's pipelined
stack does (models/gpt2.py), instead of moving every activation.

Memory: a stage keeps all M microbatches' activations until the
backward (GPipe); the bubble is (P-1)/(M+P-1) of the schedule.
"""

import dataclasses

import torch
import torch.distributed as dist

from . import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class PipelineStage:
    """A rank's place on its pipe-axis line: the process ``group``, its
    ``size`` (P), this rank's stage ``rank`` and the global ``ranks`` of
    the line in stage order."""

    group: object
    size: int
    rank: int
    ranks: tuple

    @property
    def first(self):
        return self.rank == 0

    @property
    def last(self):
        return self.rank == self.size - 1


def pipeline_stages(mesh):
    """The mesh's pipe-axis size (a ``ProcessMesh``, or its shape
    dict)."""
    shape = mesh if isinstance(mesh, dict) else mesh.shape
    return shape.get(mesh_lib.PIPE_AXIS, 1)


def pipeline_line(mesh):
    """The :class:`PipelineStage` of ``mesh``'s pipe axis, None at a pipe
    axis of 1."""
    if mesh is None or mesh.pp_size <= 1:
        return None
    return PipelineStage(mesh.pipe_group, mesh.pp_size, mesh.pipe_rank,
                         mesh.line_ranks(mesh_lib.PIPE_AXIS))


def _through_host(t, line):
    """gloo reads and writes host memory only: a CUDA tensor goes through
    a host copy on a gloo group."""
    return t.is_cuda and dist.get_backend(line.group) == "gloo"


def _send(t, line, to, tag, pending):
    """Start sending ``t`` to stage ``to``; the work and the buffer go to
    ``pending`` (waited by :func:`_wait`)."""
    t = t.detach().contiguous()
    if _through_host(t, line):
        t = t.cpu()
    pending.append((dist.isend(t, line.ranks[to], line.group, tag), t))


def _recv(shape, dtype, device, line, frm, tag):
    """A tensor of ``shape`` received from stage ``frm`` (blocking)."""
    probe = torch.empty(0, dtype=dtype, device=device)
    host = _through_host(probe, line)
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    dist.irecv(buf, line.ranks[frm], line.group, tag).wait()
    return buf.to(device) if host else buf


def _wait(pending):
    for work, _ in pending:
        work.wait()
    pending.clear()


class _GPipe(torch.autograd.Function):
    """The schedule as one autograd node: the forward runs this stage's
    microbatches (recording their graphs when ``record``), the backward
    the reverse schedule through them."""

    @staticmethod
    def forward(ctx, anchor, microbatches, run):
        del anchor
        line, n_micro, sizes = run["line"], run["n_micro"], run["sizes"]
        rest = tuple(microbatches.shape[1:])
        if sizes is None:
            shapes = [rest] * n_micro
        else:
            # pieces of different row counts, concatenated along dim 0
            shapes = [(k,) + rest for k in sizes]
        dtype, device = run["dtype"], run["device"]
        pieces = microbatches
        if line.first and sizes is not None:
            pieces = torch.split(microbatches, list(sizes))
        pending, graphs, outs = [], [], []
        with torch.set_grad_enabled(run["record"]):
            for m in range(n_micro):
                if line.first:
                    x = pieces[m].detach()
                else:
                    x = _recv(shapes[m], dtype, device, line, line.rank - 1,
                              m)
                if run["record"]:
                    x.requires_grad_()
                y = run["stage_fn"](x, m)
                if not line.last:
                    _send(y, line, line.rank + 1, m, pending)
                    graphs.append((x, y))
                    continue
                if run["last_stage_fn"] is not None:
                    y = run["last_stage_fn"](y, m).float().reshape(())
                graphs.append((x, y))
                outs.append(y.detach())
        _wait(pending)
        ctx.run, ctx.graphs = run, graphs
        scalars = run["last_stage_fn"] is not None
        if scalars:
            ctx.shape = (n_micro,)
        elif sizes is None:
            ctx.shape = (n_micro,) + shapes[0]
        else:
            ctx.shape = (sum(sizes),) + rest
        if line.last:
            out = (torch.cat(outs) if sizes is not None and not scalars
                   else torch.stack(outs))
        else:
            out = torch.zeros(ctx.shape, dtype=(
                torch.float32 if scalars else dtype), device=device)
        if run["broadcast"] and line.size > 1:
            # the last stage's outputs on every stage (the others add
            # zeros)
            if _through_host(out, line):
                host = out.cpu()
                dist.all_reduce(host, group=line.group)
                out = host.to(device)
            else:
                dist.all_reduce(out, group=line.group)
        return out

    @staticmethod
    def backward(ctx, g):
        run, graphs = ctx.run, ctx.graphs
        line, n_micro, sizes = run["line"], run["n_micro"], run["sizes"]
        if sizes is not None and run["last_stage_fn"] is None:
            g = torch.split(g, list(sizes))
        pending, dx = [], [None] * n_micro
        for m in reversed(range(n_micro)):
            x, y = graphs[m]
            if line.last:
                gy = g[m].to(y.dtype)
            else:
                gy = _recv(y.shape, y.dtype, y.device, line, line.rank + 1,
                           n_micro + m)
            torch.autograd.backward(y, gy)
            gx = x.grad if x.grad is not None else torch.zeros_like(x)
            if line.first:
                dx[m] = gx
            else:
                _send(gx, line, line.rank - 1, n_micro + m, pending)
        _wait(pending)
        ctx.graphs = None
        grad_in = None
        if line.first:
            grad_in = torch.cat(dx) if sizes is not None else torch.stack(dx)
        return None, grad_in, None


def gpipe(stage_fn, stage_params, microbatches, line, extras=None,
          last_stage_fn=None, broadcast=True, dtype=None, device=None,
          sizes=None):
    """Run ``microbatches`` ``[M, mb, ...]`` through the stages of
    ``line`` (a :class:`PipelineStage`). With ``sizes`` (M row counts)
    the microbatches are pieces of different sizes instead, concatenated
    along dim 0 (``[sum(sizes), ...]``), and so are the outputs.

    ``stage_fn(stage_params, x, mb_idx, extras) -> y`` is this stage's
    compute on one microbatch (y shaped and typed like x: it feeds the
    next stage). Only the first stage reads ``microbatches``' values; the
    others read its shape, so they may pass a ``meta`` tensor, with
    ``dtype`` and ``device`` naming the activations'. ``last_stage_fn(y,
    mb_idx, extras) -> scalar`` reduces each microbatch's output on the
    last stage, and the result is then ``[M]`` float32.

    Returns the ``[M, mb, ...]`` outputs of the last stage (or the ``[M]``
    scalars): the same on every stage with ``broadcast`` (each stage's
    backward takes its own copy's gradient, and the last stage's is the
    one that flows), else on the last stage only, zeros elsewhere. The
    backward (when autograd records) runs the reverse schedule; the
    first stage's ``microbatches`` get their gradient."""
    if dtype is None:
        dtype = microbatches.dtype
    if device is None:
        device = microbatches.device
    record = torch.is_grad_enabled()
    n_micro = microbatches.shape[0] if sizes is None else len(sizes)
    run = {"line": line, "n_micro": n_micro, "sizes": sizes, "dtype": dtype,
           "device": device, "record": record, "broadcast": broadcast,
           "stage_fn": lambda x, m: stage_fn(stage_params, x, m, extras),
           "last_stage_fn": (None if last_stage_fn is None else
                             lambda y, m: last_stage_fn(y, m, extras))}
    anchor = torch.empty(0, device=device, requires_grad=record)
    return _GPipe.apply(anchor, microbatches, run)


class _PipeBroadcast(torch.autograd.Function):
    """The last stage's value on every stage (the others hold zeros and
    add them); the gradient passes through unchanged on every stage (the
    last stage's is the one its graph reads)."""

    @staticmethod
    def forward(ctx, t, line):
        out = t.detach().clone()
        if line.size <= 1:
            return out
        if not line.last:
            out.zero_()
        if _through_host(out, line):
            host = out.cpu()
            dist.all_reduce(host, group=line.group)
            return host.to(out.device)
        dist.all_reduce(out, group=line.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipe_broadcast(t, line):
    """``t`` of the last stage on every stage of ``line``,
    differentiable."""
    return _PipeBroadcast.apply(t, line)
