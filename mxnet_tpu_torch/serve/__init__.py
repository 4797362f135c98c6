"""mx.serve: continuous-batching online inference on the card.

    import mxnet_tpu_torch as mx
    net = mx.gluon.model_zoo.GPTForCausalLM(...).initialize(seed=0)
    eng = mx.serve.load(net, max_slots=8).warmup()
    req = eng.submit(prompt_ids, max_new_tokens=64)
    eng.run()
    req.output_ids, req.ttft, eng.stats()
"""
from .engine import EngineBusy, Request, ServeEngine, load

__all__ = ["EngineBusy", "Request", "ServeEngine", "load"]
