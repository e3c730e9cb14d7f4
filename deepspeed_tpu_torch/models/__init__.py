"""Models: GPT-2 (serving slice)."""

from .gpt2 import GPT2Config, GPT2LMHeadModel

__all__ = ["GPT2Config", "GPT2LMHeadModel"]
