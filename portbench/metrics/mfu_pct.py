"""The model FLOPs of the window's work (the configuration's conv FLOPs an
image: 3 x the forward for a train step, the frozen tower once; the forward
alone for a served image) over the window's time, as a share of the cards'
bf16 peak (989 TFLOP/s a card)."""

from pb import counts


def read(run):
    flops = counts.step_flops_per_image(run.cfg, train=run.raw["backward"]) * run.raw["images"]
    return 100.0 * flops / run.raw["window_s"] / (counts.BF16_FLOPS_PER_S * run.chips)
