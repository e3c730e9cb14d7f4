"""deepspeed_tpu_torch: the PyTorch + CUDA port of deepspeed_tpu.

The JAX package (``deepspeed_tpu``) stays the reference; this package
ports it slice by slice to PyTorch, with every Pallas kernel on a
slice's path rewritten by hand in CUDA C++ for Hopper (``csrc/``). Three
slices are ported: GPT-2 serving (``init_inference`` over the paged KV
cache with the prefix cache and fused decode attention), single-device
training (``initialize``: the engine, Adam/LAMB/FusedLamb, loss scaling,
LR schedules, flash attention's backward and dropout), and multi-LoRA
(the ``adapters`` block: LoRA fine-tune on a frozen base in
``initialize``, and an adapter pool served through the SGMV kernel in
``init_inference``). Checkpoints and resilience (``resilience/``,
``runtime/checkpointing.py``) let a run on the card save, resume, heal
and hand its weights or its adapter to a serving engine. The data path
(``runtime/dataloader.py``, the staged loader of ``runtime/staging.py``
on a copy stream) and activation checkpointing (GPT-2's ``remat``, the
transformer's memory modes, ``checkpointing.py``) let it train from a
dataset and trade recompute for memory. Every optimizer of the JAX
package (Adam, AdamW, Lamb, FusedLamb, SGD, Lion) and its state layouts
(bf16/int8 moments, compensated masters, optimizer offload to pinned
host memory) train through ``initialize``, and so does BERT
(``BertForPreTraining``, ``BertForQuestionAnswering``), whose padded,
non-causal attention runs through the same flash kernels. Training runs
data parallel across processes (``runtime/dist.py``, ``parallel/``) at
ZeRO stages 0-3 (``runtime/zero.py``, the stage-3 gather stack of
``models/stack.py``), with sharded checkpoints and sparse embedding
gradients (``runtime/sparse.py``). ``python -m
deepspeed_tpu_torch.launcher.runner`` starts such a run, one process per
GPU of each host (``launcher/``). A model axis above 1 with GPT-2's
``partition_specs`` trains it Megatron-style, each rank holding its
tensor-parallel shard (``parallel/tensor.py``) beside the data axis,
and ``init_inference`` serves it over the model axis and a data axis of
replicas (global rank 0 leads, the other ranks follow its plans); a
sequence axis above 1 trains GPT-2 with ring or Ulysses attention over
the sequence (``parallel/sequence.py``), a pipe axis with GPipe and MoE
experts over the data axis, with every optimizer-state layout.
A script parses the launcher's
``--deepspeed``/``--deepspeed_config`` with :func:`add_config_arguments`
and hands the result to ``initialize(args=...)``. :func:`init_fleet`
puts a fleet router (``serving/``) in front of several serving engines,
in this process or one worker process each, with an HTTP door
(``serving.serve_http``) before it. The package imports
``torch`` and never ``jax`` or ``deepspeed_tpu``.

Entry points run on the GPU unless the caller passes ``device="cpu"``,
which runs each kernel's plain PyTorch version instead.
"""

from . import adapters, checkpointing
from .config.config import DeepSpeedConfig, DeepSpeedConfigError
from .convert import adapters_from_jax, bert_params_from_jax, params_from_jax
from .inference.engine import InferenceEngine, init_inference
from .models.bert import BertConfig, BertForPreTraining, BertForQuestionAnswering
from .models.gpt2 import GPT2Config, GPT2LMHeadModel, partition_specs
from .ops.optimizers import SGD, Adam, Lamb, Lion, Optimizer
from .ops.transformer import (
    DeepSpeedTransformerConfig,
    DeepSpeedTransformerLayer,
)
from .runtime.dataloader import DeepSpeedDataLoader
from .runtime.dist import init_distributed
from .runtime.engine import DeepSpeedEngine, EngineOptimizerFacade
from .version import __version__


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, config_params=None,
               mesh=None, rng_seed=0, device=None, collate_fn=None, mpu=None,
               dist_init_required=None, param_specs=None):
    """Build a training engine; returns the reference's 4-tuple
    ``(engine, optimizer, training_dataloader, lr_scheduler)``.

    ``model`` is a ``torch.nn.Module`` whose ``forward(*batch)`` returns
    the scalar loss (``GPT2LMHeadModel(input_ids, labels)``);
    ``model_parameters`` is None or a state dict to load into it;
    ``config_params`` a config dict or JSON path (or ``args.
    deepspeed_config``). ``device`` defaults to ``"cuda"`` and raises
    without a GPU. With ``training_data`` (a tuple of arrays, a map
    dataset or an iterable of batches; ``collate_fn`` batches a map
    dataset) the third element is a :class:`DeepSpeedDataLoader` of
    micro-batches, else None.

    Data parallel: under the launcher's ``DS_TPU_*`` environment (or in a
    torch.distributed group the caller made) every process calls this
    with its own device; ``mesh`` (a ``parallel.ProcessMesh``) or the
    config's ``mesh`` block sets the data-parallel size (default: the
    world), and ``dist_init_required``/``mpu`` are the reference's.

    Tensor parallelism: with a ``model_parallel_size`` above 1 (the
    ``mesh`` block or a ``mesh`` argument) and ``param_specs`` (GPT-2's
    ``models.partition_specs(model)``), every rank of a model-axis line
    holds and computes its Megatron shard of the model; without
    ``param_specs`` the model is replicated over the model axis, every
    model rank computing the whole step.

    Sequence parallelism: with a ``sequence_parallel_size`` above 1 every
    rank of a sequence line is fed its data rank's rows and keeps its
    chunk of the tokens (GPT-2: ring or Ulysses attention, the loss over
    the whole sequence)."""
    engine = DeepSpeedEngine(
        model=model, optimizer=optimizer, model_parameters=model_parameters,
        training_data=training_data, lr_scheduler=lr_scheduler,
        config_params=config_params, mesh=mesh, rng_seed=rng_seed,
        device=device, args=args, collate_fn=collate_fn, mpu=mpu,
        dist_init_required=dist_init_required, param_specs=param_specs,
    )
    return (engine, EngineOptimizerFacade(engine),
            engine.training_dataloader, engine.lr_scheduler)


def _add_core_arguments(parser):
    group = parser.add_argument_group("DeepSpeed", "DeepSpeed configurations")
    group.add_argument(
        "--deepspeed",
        default=False,
        action="store_true",
        help="Enable DeepSpeed (helper flag for user scripts)",
    )
    group.add_argument(
        "--deepspeed_config", default=None, type=str, help="DeepSpeed json config file"
    )
    group.add_argument(
        "--deepscale",
        default=False,
        action="store_true",
        help="Deprecated alias for --deepspeed",
    )
    group.add_argument(
        "--deepscale_config",
        default=None,
        type=str,
        help="Deprecated alias for --deepspeed_config",
    )
    group.add_argument(
        "--deepspeed_mpi",
        default=False,
        action="store_true",
        help="Run via MPI-style multi-host discovery",
    )
    return parser


def add_config_arguments(parser):
    """Add the DeepSpeed arguments to an argparse parser (the JAX
    package's and upstream's flags and defaults); ``initialize(args=...)``
    reads ``args.deepspeed_config`` (or the deprecated
    ``deepscale_config``)."""
    return _add_core_arguments(parser)


def init_fleet(
    engine_factory=None,
    worker_spec=None,
    nodes=None,
    config=None,
    registry=None,
    start=True,
):
    """Build a multi-replica serving fleet (serving/, docs/serving.md): a
    ``FleetRouter`` spreading requests over N inference-engine replicas
    with per-tenant rate limits, pluggable placement (least-loaded /
    round-robin / prefix-affinity / adapter-affinity), circuit breakers,
    brownout and rolling-restart lifecycle. Pass ``engine_factory``
    (in-process replicas) or ``worker_spec`` (one engine per worker
    subprocess), or ``nodes`` (the socket backend's fleet map — one
    ``SocketReplica`` per (node, replica) pair against running node
    agents, ``python -m deepspeed_tpu_torch.serving.node``); the
    ``"serving"`` config block sizes the fleet and arms its journal,
    autoscaler and hub. Put an HTTP door in front of the router with
    ``serving.serve_http``."""
    from .serving import init_fleet as _init_fleet

    return _init_fleet(
        engine_factory=engine_factory,
        worker_spec=worker_spec,
        nodes=nodes,
        config=config,
        registry=registry,
        start=start,
    )


__all__ = [
    "adapters",
    "adapters_from_jax",
    "add_config_arguments",
    "bert_params_from_jax",
    "BertConfig",
    "BertForPreTraining",
    "BertForQuestionAnswering",
    "checkpointing",
    "DeepSpeedConfig",
    "DeepSpeedConfigError",
    "DeepSpeedDataLoader",
    "DeepSpeedEngine",
    "DeepSpeedTransformerConfig",
    "DeepSpeedTransformerLayer",
    "EngineOptimizerFacade",
    "GPT2Config",
    "GPT2LMHeadModel",
    "InferenceEngine",
    "init_distributed",
    "init_fleet",
    "init_inference",
    "initialize",
    "Adam",
    "Lamb",
    "Lion",
    "Optimizer",
    "params_from_jax",
    "partition_specs",
    "SGD",
    "__version__",
]
