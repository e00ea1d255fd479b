"""The decoders of the port: ``llama`` (Llama-2 / Llama-3.1 / Mistral) and
``afmoe`` (Arcee's Trinity). ``decoder(cfg)`` is the module whose
``prefill`` / ``prefill_chunked`` / ``decode_step_batched`` run a
``ModelConfig``'s family."""


def decoder(cfg):
    """The decoder module of ``cfg`` (a ``config.ModelConfig``)."""
    from pqcache_tpu_torch.config import AfmoeConfig
    if isinstance(cfg, AfmoeConfig):
        from pqcache_tpu_torch.models import afmoe
        return afmoe
    from pqcache_tpu_torch.models import llama
    return llama
