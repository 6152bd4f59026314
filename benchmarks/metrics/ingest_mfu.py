"""The ingest path's share of the card's bf16 peak: the encoder FLOPs of the
passages that reached the index in the window, over their real tokens, over
the window's seconds times the peak, in percent."""

from benchmarks import roofline


def read(ctx):
    if ctx.peaks is None or not ctx.passage_tokens_reached:
        return None
    enc = ctx.config["encoder"]
    flops = sum(roofline.encoder_flops(n, enc["hidden_size"], enc["num_hidden_layers"],
                                       enc["intermediate_size"]) for n in ctx.passage_tokens_reached)
    return 100.0 * flops / (ctx.window_s * ctx.peaks["bfloat16"])
