"""GroundingDINO's BERT text encoder (port of
``vipe_tpu/priors/track_anything/gdino/bert.py``) in HuggingFace's key
layout (``embeddings.*``, ``encoder.layer.{i}.*``), with the per-phrase
self-attention mask and position ids, and the offline hash tokenizer.

The encoder is post-LN BERT (exact GELU, LayerNorm eps 1e-12) whose
self-attention takes a (B, L, L) mask: tokens attend only within their
phrase.  The tokenizer is HuggingFace's ``bert-base-uncased`` when its
vocabulary is cached locally, else ``HashTokenizer``: stable word ids with
BERT's special ids, so the phrase masks and the logit → phrase decoding
behave as with the real vocabulary.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# BERT special ids (bert-base-uncased vocabulary)
CLS_ID, SEP_ID, DOT_ID, QMARK_ID = 101, 102, 1012, 1029
SPECIAL_IDS = (CLS_ID, SEP_ID, DOT_ID, QMARK_ID)


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12


class _Dense(nn.Module):
    """``<name>.dense`` (+ ``<name>.LayerNorm``), HuggingFace's nesting."""

    def __init__(self, i: int, o: int, eps=None):
        super().__init__()
        self.dense = nn.Linear(i, o)
        if eps is not None:
            self.LayerNorm = nn.LayerNorm(o, eps=eps)


class BertSelfAttention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.num_heads = c.num_heads
        self.query = nn.Linear(c.hidden_size, c.hidden_size)
        self.key = nn.Linear(c.hidden_size, c.hidden_size)
        self.value = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, x, attn_bias):
        B, L, C = x.shape

        def heads(t):
            return t.reshape(B, L, self.num_heads, -1).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        attn = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(q.shape[-1]) + attn_bias[:, None],
                             -1)
        return (attn @ v).transpose(1, 2).reshape(B, L, C)


class _Attention(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(c)
        self.output = _Dense(c.hidden_size, c.hidden_size, c.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.attention = _Attention(c)
        self.intermediate = _Dense(c.hidden_size, c.intermediate_size)
        self.output = _Dense(c.intermediate_size, c.hidden_size, c.layer_norm_eps)

    def forward(self, x, attn_bias):
        a = self.attention.output.dense(self.attention.self(x, attn_bias))
        x = self.attention.output.LayerNorm(x + a)
        h = nn.functional.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)


class _Layers(nn.Module):
    def __init__(self, c: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(c) for _ in range(c.num_layers))


class BertEncoder(nn.Module):
    """Embeddings and post-LN layers; returns the last hidden state."""

    def __init__(self, c: BertConfig = None):
        super().__init__()
        c = c or BertConfig()
        self.embeddings = BertEmbeddings(c)
        self.encoder = _Layers(c)

    def forward(self, input_ids, attention_mask_3d, position_ids):
        """input_ids (B, L) int; attention_mask_3d (B, L, L) bool (True:
        attend); position_ids (B, L) int, restarting in each phrase."""
        e = self.embeddings
        x = (e.word_embeddings(input_ids) + e.position_embeddings(position_ids)
             + e.token_type_embeddings.weight[0])
        x = e.LayerNorm(x)
        bias = torch.where(attention_mask_3d, 0.0, -1e9).to(x.dtype)
        for layer in self.encoder.layer:
            x = layer(x, bias)
        return x


# ------------------------------------------------------------- host helpers


def generate_special_token_masks(input_ids: np.ndarray, special_ids: Sequence[int] = SPECIAL_IDS
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-phrase self-attention mask and position ids: the tokens between
    two special tokens attend only among themselves and the special token
    that closes them, and their positions restart at 0; the first and last
    tokens attend only to themselves."""
    bs, L = input_ids.shape
    special = np.isin(input_ids, np.asarray(special_ids))
    attention_mask = np.tile(np.eye(L, dtype=bool), (bs, 1, 1))
    position_ids = np.zeros((bs, L), np.int64)
    for row in range(bs):
        previous_col = 0
        for col in np.nonzero(special[row])[0]:
            if col in (0, L - 1):
                attention_mask[row, col, col] = True
                position_ids[row, col] = 0
            else:
                attention_mask[row, previous_col + 1: col + 1, previous_col + 1: col + 1] = True
                position_ids[row, previous_col + 1: col + 1] = np.arange(0, col - previous_col)
            previous_col = col
    return attention_mask, position_ids


class HashTokenizer:
    """Offline tokenizer with BERT's special ids: each lowercase word maps
    to a stable id in [2000, 30000) (32-bit FNV-1a), '.' and '?' to their
    BERT ids; a caption 'a . b c .' gives [CLS, a, ., b, c, ., SEP]."""

    def __init__(self):
        self._cache = {}

    def _word_id(self, w: str) -> int:
        if w not in self._cache:
            h = 2166136261
            for ch in w.encode():
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            self._cache[w] = 2000 + h % 28000
        return self._cache[w]

    def __call__(self, caption: str) -> List[int]:
        ids = [CLS_ID]
        for raw in caption.lower().split():
            if raw == ".":
                ids.append(DOT_ID)
                continue
            core = raw.rstrip(".?")
            if core:
                ids.append(self._word_id(core))
            for ch in raw[len(core):]:
                ids.append(DOT_ID if ch == "." else QMARK_ID)
        ids.append(SEP_ID)
        return ids


def make_tokenizer():
    """HuggingFace's bert-base-uncased tokenizer if cached locally, else
    ``HashTokenizer``."""
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained("bert-base-uncased", local_files_only=True)

        class _HF:
            def __call__(self, caption: str) -> List[int]:
                return tok(caption)["input_ids"]

        return _HF()
    except Exception:
        return HashTokenizer()
