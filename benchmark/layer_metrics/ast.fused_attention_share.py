"""Share of the AST encoder's attention calls that ran with the math backend
excluded (a fused flash, memory-efficient or cuDNN kernel), in percent: the
program's ``encoder.fused_attention_calls`` counter over its
``encoder.attention_calls`` (``models/ast.py::ASTEncoder``). None where the
program keeps no such counters."""

from benchmark import spans


def read(record):
    calls = spans.counter("encoder.attention_calls")
    if not calls:
        return None
    return 100.0 * (spans.counter("encoder.fused_attention_calls") or 0) / calls
