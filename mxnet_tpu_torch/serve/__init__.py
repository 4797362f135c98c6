"""mx.serve: continuous-batching online inference on the card.

One CUDA graph a step over a fixed-footprint slot-based KV cache; requests
are admitted and finished per step, prompts pad to buckets so no graph is
captured after ``warmup()``, and sampled tokens drain to the host through
a bounded deferred window.

    import mxnet_tpu_torch as mx
    net = mx.gluon.model_zoo.GPTForCausalLM(...).initialize(seed=0)
    eng = mx.serve.load(net, max_slots=8, eos_id=50256,
                        quantize="int8_weights").warmup()
    req = eng.submit(prompt_ids, max_new_tokens=64)
    eng.run()
    req.output_ids, req.ttft, eng.stats()
"""
from .engine import QUANTIZE_MODES, EngineBusy, Request, ServeEngine, load
from .prefix import RadixIndex
from .quantize import (dequantize_params, quantize_params_int4,
                       quantize_params_int8)

__all__ = ["EngineBusy", "Request", "ServeEngine", "load", "QUANTIZE_MODES",
           "RadixIndex", "quantize_params_int8", "quantize_params_int4",
           "dequantize_params"]
