"""RT-DETR's decoder head and its decode (port of yolo_dbl_tpu/models/rtdetr.py).

`MSDeformAttn` (multi-scale deformable attention), `DeformableDecoderLayer`,
`_MLP`, `RTDETRDecoder` (input projections, anchors, top-k query selection
from the encoder's scores, six decoder layers with iterative box
refinement) and `rtdetr_postprocess` (the final layer's boxes and scores,
sorted; no NMS). Attribute names are the flax scope names
(`input_proj_0_0`, `decoder_layers_3`, `enc_bbox_head.layers_1`, ...), so
JAX variables load key by key (utils/convert.py). The decoder takes the
model's NCHW pyramid and works on NHWC views of its projections.

The deformable attention samples with K2 (ops/resample.py
`sample_bilinear_pixel`, zeros padding): one launch a level, the 8 heads as
8 channel groups of the projected (B, H, W, 256) value, each at its own
coordinates, where JAX transposes the value to (B·8, H, W, 32) and samples
each head apart; the results are equal. Points off the map read 0.

Types follow JAX's promotions. The anchors are float32, so the reference
boxes, the sampling coordinates and the decoded boxes are float32 under a
bfloat16 model too; each Dense computes in the model's type (flax's
`dtype`), its input cast to it. JAX samples a bfloat16 value at float32
coordinates in float32 (its weights promote the taps): here the value is
upcast and sampled by the float32 kernel at the float32 coordinates, the
same arithmetic.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ..nn.attention.extra import TorchMHA
from ..nn.common import conv2d, flax_batch_norm, layer_norm, linear
from ..ops.boxes import xywh2xyxy
from ..ops.resample import sample_bilinear_pixel


def _inverse_sigmoid(x, eps: float = 1e-5):
    """log(x / (1 - x)) of x clipped to [0, 1], each side at least eps
    (rtdetr.py:36); maximum and minimum split a tie's gradient as jnp.clip's do."""
    x = torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))
    floor = torch.full_like(x, eps)
    return torch.log(torch.maximum(x, floor) / torch.maximum(1.0 - x, floor))


def sort_descending(x, dim: int = -1):
    """(values, indices) of `x` sorted from the largest, ties in index order:
    `jax.lax.top_k`'s order and `jnp.argsort(-x)`'s (a stable sort)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable attention (rtdetr.py:42): each query samples
    `n_points` points a level and a head around its reference box, weighted
    by a softmax over the levels' points."""

    def __init__(self, d_model=256, n_levels=3, n_heads=8, n_points=4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = nn.Linear(d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(d_model, n_heads * n_levels * n_points)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query, refer_bbox, values: Sequence[torch.Tensor]):
        """query (B, Q, C); refer_bbox (B, Q, 4) normalized cxcywh;
        values: each level's NHWC map (B, H, W, C)."""
        b, q, c = query.shape
        nh, nl, npt = self.n_heads, self.n_levels, self.n_points
        hd = c // nh
        offsets = linear(self.sampling_offsets, query).reshape(b, q, nh, nl, npt, 2)
        attn = torch.softmax(linear(self.attention_weights, query).reshape(b, q, nh, nl * npt), -1)
        attn = attn.reshape(b, q, nh, nl, npt)
        centers = refer_bbox[:, :, None, None, None, :2]
        wh = refer_bbox[:, :, None, None, None, 2:]
        locs = centers + offsets / npt * wh * 0.5  # normalized xy
        out = None
        for lvl, v in enumerate(values):
            v = linear(self.value_proj, v)
            vh, vw = v.shape[1:3]
            # (B, Q, nh, npt) → (B, Q·npt, nh): head h is channel group h
            gx = (locs[:, :, :, lvl, :, 0] * vw - 0.5).transpose(2, 3).reshape(b, q * npt, nh)
            gy = (locs[:, :, :, lvl, :, 1] * vh - 0.5).transpose(2, 3).reshape(b, q * npt, nh)
            sampled = sample_bilinear_pixel(v.to(gx.dtype), gy, gx, "zeros", groups=nh)
            sampled = sampled.reshape(b, q, npt, nh, hd)
            w = attn[:, :, :, lvl].transpose(2, 3)[..., None]  # (B, Q, npt, nh, 1)
            term = (sampled * w).sum(2)
            out = term if out is None else out + term
        return linear(self.output_proj, out.reshape(b, q, c).to(query.dtype))


class DeformableDecoderLayer(nn.Module):
    """Self-attention, deformable cross-attention and a ReLU feed-forward,
    each followed by a LayerNorm (rtdetr.py:87)."""

    def __init__(self, d_model=256, n_heads=8, n_levels=3, n_points=4, d_ffn=1024):
        super().__init__()
        self.self_attn = TorchMHA(d_model, n_heads)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, tgt, refer_bbox, values, query_pos):
        q = tgt + query_pos
        tgt = layer_norm(self.norm1, tgt + self.self_attn(q, q, tgt))
        tgt = layer_norm(self.norm2, tgt + self.cross_attn(tgt + query_pos, refer_bbox, values))
        f = linear(self.linear2, torch.relu(linear(self.linear1, tgt)))
        return layer_norm(self.norm3, tgt + f)


class _MLP(nn.Module):
    """`layers` Dense layers `layers_{i}`, ReLU between them (rtdetr.py:111)."""

    def __init__(self, c_in, hidden, out, layers=3):
        super().__init__()
        self.n = layers
        for i in range(layers):
            self.add_module(f"layers_{i}", nn.Linear(c_in if i == 0 else hidden,
                                                     out if i == layers - 1 else hidden))

    def forward(self, x):
        for i in range(self.n - 1):
            x = torch.relu(linear(getattr(self, f"layers_{i}"), x))
        return linear(getattr(self, f"layers_{self.n - 1}"), x)


class RTDETRDecoder(nn.Module):
    """RT-DETR's head (rtdetr.py:127) over the NCHW pyramid [P3, P4, P5].

    Returns (dec_bboxes (B, L, Q, 4) normalized cxcywh a decoder layer,
    dec_scores (B, L, Q, nc) logits, enc_bboxes (B, Q, 4), enc_scores
    (B, Q, nc)) for the Q = min(nq, tokens) queries the encoder's scores
    select. In training (`self.training`) the selected queries and each
    layer's reference boxes are detached, and layer i > 0's boxes keep the
    gradient through layer i - 1's undetached box, as in JAX. Anchors
    outside (0.01, 0.99) get a logit of +inf (their box is 1 after the
    sigmoid) and may still be selected. `denoising_class_embed` exists for
    the checkpoints: the forward never reads it.
    """

    def __init__(self, nc=80, ch=(256, 512, 1024), hd=256, nq=300, ndl=6, nh=8, ndp=4):
        super().__init__()
        self.nc, self.hd, self.nq, self.ndl = nc, hd, nq, ndl
        self.nl = len(ch)
        for i, c in enumerate(ch):
            self.add_module(f"input_proj_{i}_0", nn.Conv2d(c, hd, 1, bias=False))
            self.add_module(f"input_proj_{i}_1", flax_batch_norm(hd))
        self.enc_output_0 = nn.Linear(hd, hd)
        self.enc_output_1 = nn.LayerNorm(hd, eps=1e-5)
        self.enc_score_head = nn.Linear(hd, nc)
        self.enc_bbox_head = _MLP(hd, hd, 4)
        self.query_pos_head = _MLP(4, 2 * hd, hd, layers=2)
        self.denoising_class_embed = nn.Embedding(nc, hd)
        for i in range(ndl):
            self.add_module(f"decoder_layers_{i}", DeformableDecoderLayer(hd, nh, self.nl, ndp))
            self.add_module(f"dec_bbox_head_{i}", _MLP(hd, hd, 4))
            self.add_module(f"dec_score_head_{i}", nn.Linear(hd, nc))

    @staticmethod
    def anchors(shapes, device):
        """(anchors (1, S, 4) normalized cxcywh, valid (1, S, 1)) over the
        levels' (h, w): cell centres and a side of 0.05·2^level (rtdetr.py:157)."""
        out = []
        for lvl, (h, w) in enumerate(shapes):
            gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                    torch.arange(w, dtype=torch.float32, device=device),
                                    indexing="ij")
            xy = torch.stack([(gx + 0.5) / w, (gy + 0.5) / h], -1).reshape(-1, 2)
            wh = torch.full((h * w, 2), 0.05 * (2.0 ** lvl), device=device)
            out.append(torch.cat([xy, wh], -1))
        anchors = torch.cat(out)[None]
        valid = ((anchors > 0.01) & (anchors < 0.99)).all(-1, keepdim=True)
        return anchors, valid

    def select_queries(self, enc_scores):
        """(B, nq) indices of the tokens of highest best-class score, nq =
        min(self.nq, tokens), ties in index order (`jax.lax.top_k`'s, rtdetr.py:178)."""
        nq = min(self.nq, enc_scores.shape[1])
        return sort_descending(enc_scores.amax(-1), 1)[1][:, :nq]

    def forward(self, feats: List[torch.Tensor]):
        dt, b, hd = feats[0].dtype, feats[0].shape[0], self.hd
        proj = []
        for i, f in enumerate(feats):
            y = getattr(self, f"input_proj_{i}_1")(conv2d(getattr(self, f"input_proj_{i}_0"), f))
            proj.append(y.permute(0, 2, 3, 1))  # NHWC views
        memory = torch.cat([p.reshape(b, -1, hd) for p in proj], 1)  # (B, S, C)
        anchors, valid = self.anchors([p.shape[1:3] for p in proj], memory.device)
        anchors_logit = torch.where(valid, torch.log(anchors / (1 - anchors)),
                                    torch.full_like(anchors, float("inf")))
        masked = torch.where(valid, memory, torch.zeros((), dtype=dt, device=memory.device))

        enc_out = layer_norm(self.enc_output_1, linear(self.enc_output_0, masked))
        enc_scores = linear(self.enc_score_head, enc_out)  # (B, S, nc)
        enc_bboxes_logit = self.enc_bbox_head(enc_out) + anchors_logit  # float32
        topi = self.select_queries(enc_scores)

        def pick(t):
            return torch.gather(t, 1, topi[..., None].expand(-1, -1, t.shape[-1]))

        ref_logit = pick(enc_bboxes_logit)
        enc_sel_scores = pick(enc_scores)
        target = pick(enc_out)
        train = self.training
        tgt = target.detach() if train else target
        refer = torch.sigmoid(ref_logit)
        refer = refer.detach() if train else refer
        dec_bboxes, dec_scores, last_refined = [], [], None
        for i in range(self.ndl):
            pos = self.query_pos_head(refer.to(dt))
            tgt = getattr(self, f"decoder_layers_{i}")(tgt, refer, proj, pos)
            delta = getattr(self, f"dec_bbox_head_{i}")(tgt)
            refined = torch.sigmoid(delta + _inverse_sigmoid(refer))
            if train and i > 0:
                dec_bboxes.append(torch.sigmoid(delta + _inverse_sigmoid(last_refined)))
            else:
                dec_bboxes.append(refined)
            dec_scores.append(linear(getattr(self, f"dec_score_head_{i}"), tgt))
            last_refined = refined
            refer = refined.detach() if train else refined
        return (torch.stack(dec_bboxes, 1), torch.stack(dec_scores, 1), torch.sigmoid(ref_logit),
                enc_sel_scores)


def rtdetr_postprocess(dec_bboxes, dec_scores, img_size: int, conf: float = 0.0,
                       max_det: int = 300):
    """The final layer's outputs → (B, Q, 6) [x1, y1, x2, y2, conf, cls] in
    pixels of a square `img_size`, sorted by score (rtdetr.py:223): no NMS
    and no threshold (`conf` is unused, as in JAX)."""
    boxes = xywh2xyxy(dec_bboxes[:, -1]) * img_size
    scores = torch.sigmoid(dec_scores[:, -1])
    best = scores.amax(-1)
    cls = scores.argmax(-1).to(best.dtype)
    order = sort_descending(best, 1)[1]
    boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    dets = torch.cat([boxes, torch.gather(best, 1, order)[..., None].to(boxes.dtype),
                      torch.gather(cls, 1, order)[..., None].to(boxes.dtype)], -1)
    return dets[:, :max_det]
