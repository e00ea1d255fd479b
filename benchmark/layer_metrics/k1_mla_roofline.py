"""k1_mla_roofline: K1's latent variant's bound
(``mla_roofline.k1_latent_bytes`` over the peak bandwidth) over the time of
its two kernels (the splits and their merge) in the traced replayed
steps, in %."""

from benchmark import mla_roofline

KERNELS = ("latent_attn_kernel", "latent_merge_kernel")


def read(record):
    if not record or "events" not in record:
        return None
    us = sum(d for name, _, d in record["events"]
             if any(k in name for k in KERNELS))
    if not us:
        return None
    m = record["model"]
    need = sum(mla_roofline.k1_latent_bytes(m, record["batch"],
                                            record["prompt_tokens"], r)
               for r in record["ring"]) * m["num_hidden_layers"]
    return 100.0 * (need / mla_roofline.PEAK_BYTES) / (us / 1e6)
