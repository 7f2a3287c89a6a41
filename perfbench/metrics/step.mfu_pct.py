"""The whole step's share of the cards' published bf16 peak: the model's
matrix-product FLOPs of every step of the window (``counts.py``), over the
window's time and the peak of every card used, in percent."""


def read(t: dict) -> float | None:
    if not t["peak_flops"] or not t["window_s"]:
        return None
    rate = t["flops_per_step"] * t["window_steps"] / t["window_s"]
    return 100.0 * rate / (t["peak_flops"] * t["chips"])
