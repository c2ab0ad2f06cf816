"""Tokens an episode through the AST encoder: the program's ``encoder.tokens``
counter (the tokens of the encoder's last call, set by
``models/ast.py::ASTEncoder``) over the episodes of a unit, one encoder call
a train step. None where the program keeps no such counter."""

from benchmark import spans


def read(record):
    tokens = spans.counter("encoder.tokens")
    if not tokens:
        return None
    return tokens / record["episodes_per_unit"]
