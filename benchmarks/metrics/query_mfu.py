"""The whole query path's share of the card's bf16 peak: the FLOPs the
window's answered queries need (the encoder over their real tokens, and
exact scoring against every row of the index) over the window's seconds
times the peak, in percent."""

from benchmarks import roofline


def read(ctx):
    if ctx.peaks is None or not ctx.query_tokens_answered:
        return None
    enc = ctx.config["encoder"]
    flops = sum(roofline.encoder_flops(n, enc["hidden_size"], enc["num_hidden_layers"],
                                       enc["intermediate_size"]) for n in ctx.query_tokens_answered)
    flops += roofline.scoring_flops(len(ctx.query_tokens_answered), ctx.index_rows, enc["hidden_size"])
    return 100.0 * flops / (ctx.window_s * ctx.peaks["bfloat16"])
