"""Operations of the transformer parts that CounTR and its MAE share,
counted as the architecture needs them (2 per multiply-add; softmax,
norms and activations left out, as is usual for model FLOPs)."""


def block(n: int, c: int, hidden: int) -> float:
    """A pre-norm ViT block on n tokens of width c: qkv, QK^T, PV, proj,
    and the two MLP products."""
    return 2.0 * n * c * 3 * c + 4.0 * n * n * c + 2.0 * n * c * c + 4.0 * n * c * hidden


def cross_block(n: int, m: int, c: int, hidden: int) -> float:
    """CounTR's decoder block: a self-attention block's work plus
    cross-attention to m exemplar tokens (q and proj on the n image
    tokens, k and v on the m exemplar tokens, QK^T and PV)."""
    cross = 4.0 * n * c * c + 4.0 * m * c * c + 4.0 * n * m * c
    return block(n, c, hidden) + cross


def linear(n: int, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k
