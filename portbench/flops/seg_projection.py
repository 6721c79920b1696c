"""LISA's [SEG] projection MLP (text_hidden_fcs) on one hidden state."""


def count(d_model: int, out_dim: int, batch: int = 1) -> dict:
    return {"flops": batch * 2 * (d_model * d_model + d_model * out_dim)}
