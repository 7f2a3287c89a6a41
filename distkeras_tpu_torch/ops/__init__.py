"""Ops: attention (dense, paged, the dense ring), the flash kernels, the
fused cross-entropy, losses and metrics. The sequence-parallel attention
(``ring_flash``, ``ulysses``) and its functions resolve on first use."""

_LAZY = {
    "ring_flash": ("distkeras_tpu_torch.ops.ring_flash", None),
    "ulysses": ("distkeras_tpu_torch.ops.ulysses", None),
    "ring_flash_attention": ("distkeras_tpu_torch.ops.ring_flash", "ring_flash_attention"),
    "stripe_shard": ("distkeras_tpu_torch.ops.ring_flash", "stripe_shard"),
    "stripe_unshard": ("distkeras_tpu_torch.ops.ring_flash", "stripe_unshard"),
    "ulysses_attention": ("distkeras_tpu_torch.ops.ulysses", "ulysses_attention"),
    "ulysses_self_attention": ("distkeras_tpu_torch.ops.ulysses", "ulysses_self_attention"),
    "ring_attention": ("distkeras_tpu_torch.ops.attention", "ring_attention"),
    "ring_self_attention": ("distkeras_tpu_torch.ops.attention", "ring_self_attention"),
}


def __getattr__(name):
    import importlib

    if name in _LAZY:
        module, attr = _LAZY[name]
        module = importlib.import_module(module)
        return module if attr is None else getattr(module, attr)
    raise AttributeError(name)
