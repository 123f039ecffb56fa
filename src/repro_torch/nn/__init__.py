"""repro_torch.nn — shared neural-net layers (``layers``: linear, norms, MLP,
RoPE, softcap), attention (``attention``: the reference's direct and
chunked paths, and B6 ``flash_attention`` on the card) and the
mixture-of-experts FFN (``moe``: grouped top-k routing with capacity), and
the DTensor placement helpers their partitioned program runs on
(``partition``)."""
