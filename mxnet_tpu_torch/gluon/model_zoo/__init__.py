"""Model zoo: the GPT family (serving, training), BERT (pretraining) and
the ResNets (``vision``)."""
from . import bert, gpt, vision
from .bert import (BERTForPretraining, BERTModel, bert_12_768_12,
                   bert_24_1024_16, bert_base, bert_large)
from .gpt import GPTForCausalLM, GPTModel, gpt2_124m, gpt2_355m

__all__ = ["bert", "gpt", "vision", "BERTModel", "BERTForPretraining",
           "bert_12_768_12", "bert_24_1024_16", "bert_base", "bert_large",
           "GPTModel", "GPTForCausalLM", "gpt2_124m", "gpt2_355m"]
