"""The decoders of the port: ``llama`` (Llama-2 / Llama-3.1 / Mistral),
``afmoe`` (Arcee's Trinity) and ``deepseek_v2`` (DeepSeek-V2's latent
attention and experts). ``decoder(cfg)`` is the module whose ``prefill`` /
``prefill_chunked`` / ``decode_step_batched`` run a ``ModelConfig``'s
family; ``require_llama(cfg, engine)`` is the refusal of an engine that
runs the llama family alone."""


def decoder(cfg):
    """The decoder module of ``cfg`` (a ``config.ModelConfig``)."""
    from pqcache_tpu_torch.config import AfmoeConfig, DeepseekV2Config
    if isinstance(cfg, AfmoeConfig):
        from pqcache_tpu_torch.models import afmoe
        return afmoe
    if isinstance(cfg, DeepseekV2Config):
        from pqcache_tpu_torch.models import deepseek_v2
        return deepseek_v2
    from pqcache_tpu_torch.models import llama
    return llama


def require_llama(cfg, engine: str) -> None:
    """Raise a ValueError unless ``cfg`` (a ``config.ModelConfig``) is of
    the llama family, the only one that ``engine`` runs; the AFMoE and
    DeepSeek-V2 families are served by
    ``runtime/decode_graph.BatchedDecoder``."""
    from pqcache_tpu_torch.config import AfmoeConfig, DeepseekV2Config
    if isinstance(cfg, (AfmoeConfig, DeepseekV2Config)):
        family = "afmoe" if isinstance(cfg, AfmoeConfig) else "deepseek_v2"
        raise ValueError(
            f"{engine} runs the llama family; {cfg.name!r} is of the "
            f"{family} family, which runtime/decode_graph.BatchedDecoder "
            f"serves")
