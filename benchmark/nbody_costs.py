"""The yardstick's arithmetic for Neural Body (benchmark/configs/
neuralbody-zju.json), beside benchmark/costs.py: the analytic FLOPs of the
sparse stack at a frame's active sites and of the per-sample network, and
the bytes the point network must move at least. The card's peaks are
costs.py's.

  * `POINT_FLOPS`: one sample through the MLP at the published widths,
    twice its 429,952 multiply-adds: fc_0 352x256, fc_1 and fc_2 256x256,
    alpha_fc 256x1, feature_fc 256x256, latent_fc 384x256, view_fc 346x128,
    rgb_fc 128x3 (the biases, activations, encodings and the query's
    lerps left out);
  * `volume_flops`: each sparse conv as 27 taps x Cin x Cout multiply-adds
    at each active site of its output level (conv0 at level 0; level i + 1
    its strided conv and its submanifold convs);
  * `point_bytes`: the four volumes read once, in bfloat16, at the frame's
    level sizes out_sh // 2^(i + 1), and 16 B (rgb and sigma, float32) a
    sample written.
"""

from __future__ import annotations

CODE_DIM = 16
OUT_DIM = (32, 64, 128, 128)
CONVS = (2, 2, 3, 3, 3)
WIDTH, VIEW_WIDTH, LATENT_DIM = 256, 128, 128
XYZ_ENC, VIEW_ENC = 63, 27
MULTIPLY_ADDS = (sum(OUT_DIM) * WIDTH + 2 * WIDTH * WIDTH + WIDTH + WIDTH * WIDTH
                 + (WIDTH + LATENT_DIM) * WIDTH + (WIDTH + VIEW_ENC + XYZ_ENC) * VIEW_WIDTH
                 + VIEW_WIDTH * 3)
POINT_FLOPS = 2 * MULTIPLY_ADDS
VOLUME_VALUE_BYTES = 2
POINT_OUT_BYTES = 16


def volume_flops(sites):
    """The sparse stack at the active sites of levels 0-4."""
    f = 2 * 27 * CONVS[0] * CODE_DIM * CODE_DIM * sites[0]
    cin = CODE_DIM
    for i, c in enumerate(OUT_DIM):
        f += 2 * 27 * (cin * c + CONVS[i + 1] * c * c) * sites[i + 1]
        cin = c
    return f


def point_flops(points):
    return POINT_FLOPS * points


def point_bytes(points, out_sh):
    """The least bytes of the point network over `points` samples of a
    frame whose level-0 grid is out_sh (D, H, W)."""
    vol = 0
    for i, c in enumerate(OUT_DIM):
        s = [int(v) >> (i + 1) for v in out_sh]
        vol += s[0] * s[1] * s[2] * c * VOLUME_VALUE_BYTES
    return vol + POINT_OUT_BYTES * points
