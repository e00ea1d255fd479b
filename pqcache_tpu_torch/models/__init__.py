"""The decoders of the port: ``llama`` (Llama-2 / Llama-3.1 / Mistral) and
``afmoe`` (Arcee's Trinity). ``decoder(cfg)`` is the module whose
``prefill`` / ``prefill_chunked`` / ``decode_step_batched`` run a
``ModelConfig``'s family; ``require_llama(cfg, engine)`` is the refusal of
an engine that runs the llama family alone."""


def decoder(cfg):
    """The decoder module of ``cfg`` (a ``config.ModelConfig``)."""
    from pqcache_tpu_torch.config import AfmoeConfig
    if isinstance(cfg, AfmoeConfig):
        from pqcache_tpu_torch.models import afmoe
        return afmoe
    from pqcache_tpu_torch.models import llama
    return llama


def require_llama(cfg, engine: str) -> None:
    """Raise a ValueError unless ``cfg`` (a ``config.ModelConfig``) is of
    the llama family, the only one that ``engine`` runs; the AFMoE family
    is served by ``runtime/decode_graph.BatchedDecoder``."""
    from pqcache_tpu_torch.config import AfmoeConfig
    if isinstance(cfg, AfmoeConfig):
        raise ValueError(
            f"{engine} runs the llama family; {cfg.name!r} is of the afmoe "
            f"family, which runtime/decode_graph.BatchedDecoder serves")
