"""The slice-wide parity check's model for tests/test_torch_jit.py,
tests/test_torch_static.py and tests/test_torch_predictor.py: the encoder
classifier of ``chip_smoke.dygraph_encoder`` (token and position
embeddings, LayerNorm, a TransformerEncoder with dropout 0 and gelu, a
Linear head on the first token) at 2 layers x 32 wide, built in either
package, and its AdamW."""

import numpy as np

import paddle_tpu as jp
import paddle_tpu_torch as pt
from paddle_tpu_torch.weights import load_jax_state, state_from_jax_layer

BOTH = (jp, pt)

ENC = dict(vocab=64, hidden=32, heads=4, ffn=64, layers=2, max_pos=16,
           labels=2)
ENC_BATCH, ENC_SEQ, ENC_STEPS, ENC_LR = 4, 8, 3, 1e-2


def encoder(P):
    """chip_smoke.dygraph_encoder's classifier in package P (no device
    argument: the JAX layers take none)."""
    c = ENC

    class Encoder(P.nn.Layer):
        def __init__(self):
            super().__init__()
            h = c["hidden"]
            self.word = P.nn.Embedding(c["vocab"], h)
            self.pos = P.nn.Embedding(c["max_pos"], h)
            self.norm = P.nn.LayerNorm(h)
            self.encoder = P.nn.TransformerEncoder(
                P.nn.TransformerEncoderLayer(h, c["heads"], c["ffn"],
                                             dropout=0.0,
                                             activation="gelu"),
                c["layers"])
            self.head = P.nn.Linear(h, c["labels"])

        def forward(self, ids):
            pos = P.arange(ids.shape[1]).unsqueeze(0)
            x = self.norm(self.word(ids) + self.pos(pos))
            return self.head(self.encoder(x)[:, 0])

    return Encoder()


def encoder_pair():
    """The encoder in both packages (eager construction), the port's on
    the JAX weights, and a seed-0 batch."""
    was = [P.in_static_mode() for P in BOTH]
    for P in BOTH:
        P.disable_static()
    jm, tm = encoder(jp), encoder(pt)
    load_jax_state(tm, state_from_jax_layer(jm))
    for P, w in zip(BOTH, was):
        if w:
            P.enable_static()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, ENC["vocab"], (ENC_BATCH, ENC_SEQ))
    labels = rng.integers(0, ENC["labels"], (ENC_BATCH,))
    return jm, tm, ids, labels


def adamw(P, model):
    return P.optimizer.AdamW(ENC_LR, parameters=model.parameters(),
                             weight_decay=0.01,
                             grad_clip=P.nn.ClipGradByGlobalNorm(1.0))


def _np(t):
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t)


def check_updated_weights(tm, jm):
    """Every weight within 1e-5 of JAX's, but the attention's k biases:
    their gradient is zero to rounding (softmax ignores a shift of a row's
    logits), and Adam moves a weight about lr a step whatever its gradient,
    so theirs are held to the Adam bound 2 x lr x steps."""
    jstate = state_from_jax_layer(jm)
    for name, p in tm.state_dict().items():
        if name.endswith("k_proj.bias"):
            assert np.abs(_np(p) - jstate[name]).max() <= \
                2 * ENC_LR * ENC_STEPS, name
            continue
        try:
            a, b = _np(p), jstate[name]
            assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(b).max())
        except AssertionError as e:
            raise AssertionError(name) from e
