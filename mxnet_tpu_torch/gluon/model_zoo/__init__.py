"""Model zoo (serving slice: the GPT family)."""
from . import gpt
from .gpt import GPTForCausalLM, GPTModel, gpt2_124m, gpt2_355m

__all__ = ["gpt", "GPTModel", "GPTForCausalLM", "gpt2_124m", "gpt2_355m"]
