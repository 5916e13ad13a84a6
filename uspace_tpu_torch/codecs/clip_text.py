"""The CLIP text tower (frozen codec) and the token helpers of prompt-to-
prompt editing.

Counterpart of ``uspace_tpu/codecs/clip_text.py``: the text tower of
``openai/clip-vit-large-patch14`` (pre-LN transformer, causal mask,
quick-GELU), which returns ``last_hidden_state`` [B, 77, 768]. The causal
mask adds f32 ``finfo.min`` above the diagonal, not -inf, as the JAX
package's does. Its attention is plain PyTorch math, as the JAX package
leaves its attention to XLA: f32 scores and softmax, P cast to V's dtype.
Parameters load from the JAX tree with ``codecs/convert.load_clip_from_jax``.

Tokenization is string processing on the host and needs the tokenizer's
vocabulary, which is not in the repository: :class:`FrozenCLIPEmbedder`
refuses without a tokenizer, and :func:`get_word_inds` takes one.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..models.layers import Dense, Embedding, LayerNorm

CLIP_L14 = dict(  # openai/clip-vit-large-patch14 text tower
    vocab_size=49408,
    hidden_size=768,
    intermediate_size=3072,
    num_layers=12,
    num_heads=12,
    max_length=77,
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPLayer(nn.Module):
    """One pre-LN layer: causal self-attention, then the quick-GELU MLP."""

    def __init__(self, hidden: int, intermediate: int, heads: int, **kw):
        super().__init__()
        dtype, device = kw["dtype"], kw.get("device")
        self.heads = heads
        self.ln1 = LayerNorm(hidden, dtype=dtype, device=device)
        self.q = Dense(hidden, hidden, **kw)
        self.k = Dense(hidden, hidden, **kw)
        self.v = Dense(hidden, hidden, **kw)
        self.out = Dense(hidden, hidden, **kw)
        self.ln2 = LayerNorm(hidden, dtype=dtype, device=device)
        self.fc1 = Dense(hidden, intermediate, **kw)
        self.fc2 = Dense(intermediate, hidden, **kw)

    def forward(self, h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, l, c = h.shape
        hd = c // self.heads
        y = self.ln1(h)
        q, k, v = (m(y).reshape(b, l, self.heads, hd).transpose(1, 2)
                   for m in (self.q, self.k, self.v))
        s = torch.matmul(q.float(), k.float().transpose(-1, -2))
        p = torch.softmax(s * hd ** -0.5 + bias, dim=-1).to(v.dtype)
        o = torch.matmul(p, v).transpose(1, 2).reshape(b, l, c)
        h = h + self.out(o)
        return h + self.fc2(quick_gelu(self.fc1(self.ln2(h))))


class CLIPTextEncoder(nn.Module):
    """input_ids [B, L] -> last_hidden_state [B, L, hidden]."""

    def __init__(self, vocab_size: int = 49408, hidden_size: int = 768,
                 intermediate_size: int = 3072, num_layers: int = 12,
                 num_heads: int = 12, max_length: int = 77,
                 dtype: torch.dtype = torch.float32, param_dtype=None,
                 device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.token_embedding = Embedding(vocab_size, hidden_size, **kw)
        self.position_embedding = Embedding(max_length, hidden_size, **kw)
        self.layers = nn.ModuleList(
            CLIPLayer(hidden_size, intermediate_size, num_heads, **kw)
            for _ in range(num_layers))
        self.final_ln = LayerNorm(hidden_size, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPTextEncoder":
        """Seeded random init as Flax's defaults: a normal of std
        features^-1/2 for the embeddings, LeCun normal for the denses,
        zero biases, unit LayerNorm scales."""
        from ..models.layers import lecun_normal_

        for mod in self.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.copy_(torch.randn(
                    mod.weight.shape, generator=generator,
                    device=mod.weight.device) * mod.weight.shape[1] ** -0.5)
            elif isinstance(mod, nn.Linear):
                lecun_normal_(mod.weight, generator)
                mod.bias.zero_()
        return self

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        l = input_ids.shape[1]
        pos = torch.arange(l, device=input_ids.device)
        h = self.token_embedding(input_ids) + self.position_embedding(pos)[None]
        causal = torch.ones((l, l), dtype=torch.bool,
                            device=input_ids.device).tril()
        bias = torch.where(causal, 0.0, torch.finfo(torch.float32).min)
        for layer in self.layers:
            h = layer(h, bias)
        return self.final_ln(h)


def clip_hf_to_torch(state_dict) -> dict:
    """A Hugging Face ``CLIPTextModel`` state dict (``pytorch_model.bin``)
    under :class:`CLIPTextEncoder`'s names: ``text_model.`` dropped,
    ``embeddings.*_embedding`` -> ``*_embedding``, ``final_layer_norm`` ->
    ``final_ln``, ``encoder.layers.i.self_attn.{q,k,v,out}_proj`` ->
    ``layers.i.{q,k,v,out}``, ``layer_norm1/2`` -> ``ln1/2``, ``mlp.fc1/2``
    -> ``fc1/2`` (the JAX package's ``clip_torch_to_flax`` map); the
    ``position_ids`` buffer is left out."""
    out = {}
    for key, v in state_dict.items():
        if "position_ids" in key:
            continue
        k = key[len("text_model."):] if key.startswith("text_model.") else key
        k = (k.replace("embeddings.token_embedding", "token_embedding")
             .replace("embeddings.position_embedding", "position_embedding")
             .replace("final_layer_norm", "final_ln")
             .replace("encoder.layers.", "layers.")
             .replace("self_attn.out_proj", "out")
             .replace("layer_norm1", "ln1").replace("layer_norm2", "ln2")
             .replace("mlp.fc1", "fc1").replace("mlp.fc2", "fc2"))
        for p in "qkv":
            k = k.replace(f"self_attn.{p}_proj", p)
        out[k] = v
    return out


def get_word_inds(text: str, word_place, tokenizer) -> np.ndarray:
    """Token positions of a word within the padded 77-token encoding (the
    reference's ``libs/clip.py:6-27``); the p2p target ids."""
    split_text = text.split(" ")
    if isinstance(word_place, str):
        word_place = [i for i, word in enumerate(split_text)
                      if word_place == word]
    elif isinstance(word_place, int):
        word_place = [word_place]
    out = []
    if len(word_place) > 0:
        words_encode = [tokenizer.decode([item]).strip("#")
                        for item in tokenizer.encode(text)][1:-1]
        cur_len, ptr = 0, 0
        for i, word in enumerate(words_encode):
            cur_len += len(word)
            if ptr in word_place:
                out.append(i + 1)
            if cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.array(out)


class FrozenCLIPEmbedder:
    """Text -> [B, 77, 768] context on the host's tokenizer and a
    :class:`CLIPTextEncoder` (the reference's ``libs/clip.py:38-91``).
    Needs a tokenizer (the CLIP vocabulary is not in the repository)."""

    def __init__(self, encoder: CLIPTextEncoder, tokenizer,
                 max_length: int = 77):
        if tokenizer is None:
            raise RuntimeError(
                "FrozenCLIPEmbedder needs a CLIP tokenizer (its vocabulary "
                "files are not in the repository)")
        self.encoder = encoder
        self.tokenizer = tokenizer
        self.max_length = max_length

    @property
    def device(self) -> torch.device:
        return next(self.encoder.parameters()).device

    def tokenize(self, texts: Sequence[str]) -> np.ndarray:
        enc = self.tokenizer(list(texts), truncation=True,
                             max_length=self.max_length,
                             padding="max_length", return_tensors="np")
        return enc["input_ids"]

    @torch.no_grad()
    def encode(self, texts: Sequence[str]) -> torch.Tensor:
        ids = torch.as_tensor(self.tokenize(texts), device=self.device)
        return self.encoder(ids)


def build_clip(config: Optional[dict] = None, device=None, seed: int = 0,
               dtype: torch.dtype = torch.float32) -> CLIPTextEncoder:
    """A text tower of ``config`` (CLIP-L/14's by default) on ``device``
    (CUDA unless "cpu") with seeded random weights."""
    dev = resolve_device(device)
    enc = CLIPTextEncoder(**dict(config or CLIP_L14), dtype=dtype,
                          param_dtype=torch.float32, device=dev)
    return enc.init_weights(torch.Generator(device=dev).manual_seed(seed))
