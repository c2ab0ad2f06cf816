"""Recurrent stack of the Hybrid encoder.

Counterpart of the JAX package's ``ops/rnn.py``, whose scan cells follow
torch's gate order (GRU r, z, n; LSTM i, f, g, o) and weight layout, so the
port uses ``torch.nn.RNN`` / ``GRU`` / ``LSTM`` directly. Its parameters are
named ``weight_ih_l{k}[_reverse]`` etc., which are the reference checkpoint's
keys under ``backbone.encoder.seq_layers``.
"""

from __future__ import annotations

from torch import nn

_CELLS = {"RNN": nn.RNN, "GRU": nn.GRU, "LSTM": nn.LSTM}


def Recurrent(
    input_size: int,
    hidden_size: int,
    num_layers: int = 1,
    cell_type: str = "RNN",
    bidirectional: bool = False,
) -> nn.Module:
    """Batch-first recurrent stack: ``[B, T, I] -> ([B, T, H*dirs], state)``;
    a bidirectional output is ``[forward ; backward]`` on the feature axis."""
    if cell_type not in _CELLS:
        raise ValueError("Seq type not recognised")
    return _CELLS[cell_type](
        input_size,
        hidden_size,
        num_layers=num_layers,
        batch_first=True,
        bidirectional=bidirectional,
    )
