"""Host ms a traced request spends in the program's `predictor.post`
span: detokenizing and the crop and bilinear resize of both masks to the
frame, after the answer has come back from the card."""

from ..program_spans import host_ms_per_req


def read(ctx):
    return host_ms_per_req(ctx, "predictor.post")
