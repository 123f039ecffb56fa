"""repro_torch.nn — shared neural-net layers (``layers``: linear, norms, MLP,
RoPE, softcap) and attention (``attention``: the reference's direct and
chunked paths, and B6 ``flash_attention`` on the card).  ``moe`` waits for
ROADMAP A13b."""
