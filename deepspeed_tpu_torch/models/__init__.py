"""Models: GPT-2 (serving and training) and BERT (pretraining and QA)."""

from .bert import (
    BertConfig,
    BertForPreTraining,
    BertForQuestionAnswering,
    BertModel,
)
from .gpt2 import GPT2Config, GPT2LMHeadModel, partition_specs

__all__ = [
    "BertConfig",
    "BertForPreTraining",
    "BertForQuestionAnswering",
    "BertModel",
    "GPT2Config",
    "GPT2LMHeadModel",
    "partition_specs",
]
