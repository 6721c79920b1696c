"""Host ms a traced request spends in the program's `predictor.collate`
span: the tokenizer, the SAM and CLIP preprocessing and the padding, with
no work queued for the card."""

from ..program_spans import host_ms_per_req


def read(ctx):
    return host_ms_per_req(ctx, "predictor.collate")
