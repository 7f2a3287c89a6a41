"""Deploy-loop wiring: golden sets, golden-batch scoring, one-call setup.

Counterpart of the reference's ``distkeras_tpu/deploy/harness.py``.
``run.py deploy`` and the tests need the same three pieces around a
cluster: a deterministic golden prompt set, a golden-batch loss for the
canary's finite-loss check, and a
:class:`~distkeras_tpu_torch.deploy.controller.DeployController` registered
on the router (which is what makes the ``deployz`` verb answer). This module
is that shared wiring; torch loads only inside the score function, so the
CLI can parse its arguments without paying for it.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_golden_prompts", "make_score_fn", "wire_controller"]


def make_golden_prompts(vocab: int, count: int = 4, length: int = 8,
                        seed: int = 0) -> list[list[int]]:
    """Deterministic golden prompt set: same seed -> same prompts, so a
    canary score is comparable deploy over deploy."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(length,)).tolist()
            for _ in range(max(0, count))]


def make_score_fn(model, vocab: int, seq_len: int = 16, batch: int = 4,
                  seed: int = 0, device=None, warmup=None):
    """Golden-batch next-token loss under candidate weights.

    The canary's "finite loss" check: a fixed random token batch scored
    with the candidate's forward pass (the port's ``Model.apply``) and the
    plain :func:`~distkeras_tpu_torch.ops.losses.categorical_crossentropy`
    — NaN/inf weights (or a head that went numerically sideways) show up
    here as a non-finite loss before the candidate ever serves a request.
    The batch is deterministic per seed. Candidates arrive as weight trees
    of either layout (a weight file's ``{"params": ...}`` or the port's
    flat ``state_dict``) and are scored on ``device`` (CUDA unless
    ``"cpu"`` is asked for).

    ``warmup``: a weight tree (typically the validation template) to score
    once AT BUILD TIME, off the deploy clock, so the first forward's
    one-time costs (kernel loading, allocator growth) never land inside
    the first deploy's latency window.
    """
    import torch

    from distkeras_tpu_torch.ops.losses import categorical_crossentropy
    from distkeras_tpu_torch.utils.bridge import as_state_dict
    from distkeras_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(
        rng.integers(0, vocab, size=(batch, seq_len)), dtype=torch.int32,
        device=dev)

    @torch.inference_mode()
    def score(variables):
        logits, _ = model.apply(as_state_dict(variables, device=dev), tokens, train=False)
        return float(categorical_crossentropy(logits[:, :-1], tokens[:, 1:]))

    if warmup is not None:
        try:
            score(warmup)
        except Exception as e:
            # A warmup failure must never block wiring — the real
            # candidate's score reports its own error — but it must be
            # VISIBLE.
            import warnings

            warnings.warn(
                f"golden score_fn warmup failed ({e!r}); the first "
                f"deploy will pay the first forward on its clock",
                RuntimeWarning, stacklevel=2)
    return score


def wire_controller(router, watch_dir: str, *, model=None,
                    template=None, vocab: int | None = None,
                    golden_count: int = 4, golden_len: int = 8,
                    golden_new_tokens: int = 4, seed: int = 0,
                    registry=None, device=None, **controller_kwargs):
    """Build a :class:`DeployController` over ``router`` watching
    ``watch_dir`` and register it for the ``deployz`` verb.

    With ``model`` + ``vocab``, the golden prompt set and the golden-batch
    ``score_fn`` (on ``device``) are built automatically (pass
    ``golden_count=0`` to skip replica-side scoring); the score function is
    WARMED here against the template. ``template`` defaults to the model's
    seed-``seed`` weights on the host — the leaf name/shape/dtype
    validation template.
    """
    from distkeras_tpu_torch.deploy.controller import DeployController

    golden = None
    score_fn = None
    if model is not None and vocab:
        golden = make_golden_prompts(vocab, count=golden_count,
                                     length=golden_len, seed=seed)
        if template is None:
            template = model.init(seed, device="cpu")
        score_fn = make_score_fn(model, vocab, seed=seed, device=device,
                                 warmup=template)
    controller = DeployController(
        router, watch_dir, template=template, golden_prompts=golden,
        golden_new_tokens=golden_new_tokens, score_fn=score_fn,
        registry=registry, **controller_kwargs)
    router.deploy_controller = controller
    return controller
