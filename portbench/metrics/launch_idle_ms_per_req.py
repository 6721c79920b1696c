"""Device-idle ms a traced request spends under the evaluate's eager
stages (the program's `evaluate.inputs`, `.prompt`, `.prefill` and
`.finish` spans): time the card waits for the host to launch the next
kernel or copy."""

from ..program_spans import idle_ms_per_req

EAGER = ("evaluate.inputs", "evaluate.prompt", "evaluate.prefill",
         "evaluate.finish")


def read(ctx):
    return idle_ms_per_req(ctx, EAGER)
