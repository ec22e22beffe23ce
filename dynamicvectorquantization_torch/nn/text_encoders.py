"""Text encoders of the text-to-image stage-2 model (counterpart of
`dynamicvectorquantization_tpu/nn/text_encoders.py`): `encode_text(texts,
device=None)` -> (features (B, max_length, D) f32, mask (B, max_length) f32
with 1 on the tokens that are there), both on `device` (the CPU when None).

* `HashTextEncoder`, the default: whitespace words looked up in a seeded
  numpy table by Python's `hash(word)`. That hash is salted per process
  (`PYTHONHASHSEED`), so the features of one caption differ between
  processes; the JAX package's encoder does the same, and is kept so (a
  reference quirk): compare the two packages within one process.
* `NativeCLIPTextEncoder`: the byte-level BPE tokenizer
  (`utils/clip_bpe.py`) and the CLIP text tower (`nn/clip_text.py`), the
  sequence after `ln_final`, unnormalised; OpenAI weights from
  `weights_path` / `DQVQ_CLIP_WEIGHTS`, else seeded. The tower moves to the
  device a call asks for; its attention is kernel #4 there.
* `CLIPTextEncoder`, `BERTTextEncoder`: HuggingFace `transformers` models
  read from a local path, moved to the device a call asks for and run
  there. `transformers` is imported in their constructors only, never at
  module load.
"""
from __future__ import annotations

import os

import numpy as np
import torch


class HashTextEncoder:
    """Dependency-free: whitespace words embedded by a seeded hash table.
    Deterministic within a process; for pipeline tests, not semantics."""

    def __init__(self, embed_dim=512, max_length=77, vocab_hash_buckets=4096, seed=0):
        self.embed_dim = embed_dim
        self.max_length = max_length
        self.buckets = vocab_hash_buckets
        rng = np.random.default_rng(seed)
        self.table = rng.normal(0, 0.02, (vocab_hash_buckets, embed_dim)).astype(np.float32)

    def encode_text(self, texts, device=None):
        out = np.zeros((len(texts), self.max_length, self.embed_dim), np.float32)
        mask = np.zeros((len(texts), self.max_length), np.float32)
        for i, t in enumerate(texts):
            for j, w in enumerate(str(t).lower().split()[: self.max_length]):
                out[i, j] = self.table[hash(w) % self.buckets]
                mask[i, j] = 1.0
        return torch.from_numpy(out).to(device), torch.from_numpy(mask).to(device)


class _HFEncoder:
    """A `transformers` text model and its tokenizer from a local path; the
    last hidden state, computed on the caller's `device` (the model moves
    there, as `NativeCLIPTextEncoder`'s tower does)."""

    def __init__(self, model_path: str, max_length: int, auto: bool):
        # the model is torch: keep `transformers` (where it is first imported
        # here) from loading TensorFlow or Flax, and with them JAX, beside it
        os.environ.setdefault("USE_TF", "0")
        os.environ.setdefault("USE_FLAX", "0")
        if auto:
            from transformers import AutoModel as Model
            from transformers import AutoTokenizer as Tokenizer
        else:
            from transformers import CLIPTextModel as Model
            from transformers import CLIPTokenizer as Tokenizer
        self.tokenizer = Tokenizer.from_pretrained(model_path)
        self.model = Model.from_pretrained(model_path).eval()
        self.max_length = max_length

    @torch.no_grad()
    def encode_text(self, texts, device=None):
        if device is not None:
            self.model.to(device)
        toks = self.tokenizer(list(texts), padding="max_length", truncation=True,
                              max_length=self.max_length, return_tensors="pt")
        toks = {k: v.to(self.model.device) for k, v in toks.items()}
        out = self.model(**toks).last_hidden_state.float()
        return out, toks["attention_mask"].float()


class CLIPTextEncoder(_HFEncoder):
    """CLIP text tower through `transformers` (local weights path)."""

    def __init__(self, model_path: str, max_length: int = 77):
        super().__init__(model_path, max_length, auto=False)


class BERTTextEncoder(_HFEncoder):
    """BERT through `transformers` (local weights path)."""

    def __init__(self, model_path: str, max_length: int = 77):
        super().__init__(model_path, max_length, auto=True)


class NativeCLIPTextEncoder:
    """The port's CLIP text tower and byte-level BPE behind the same
    `encode_text` as the HF wrappers; seeded from `seed` without weights, and
    without a merge table the byte-level vocabulary."""

    def __init__(self, clip_name: str = "ViT-B/32", max_length: int = 77, weights_path=None,
                 bpe_path=None, seed: int = 0):
        from ..utils.clip_bpe import ClipBPETokenizer
        from .clip_text import CLIPTextEmbedding

        self.tokenizer = ClipBPETokenizer(bpe_path=bpe_path)
        self.embedding = CLIPTextEmbedding(
            clip_name=clip_name, num_embed=max(self.tokenizer.vocab_size, 49408),
            pick_last_embedding=False, normalize=False, weights_path=weights_path, seed=seed)
        self.max_length = max_length

    def encode_text(self, texts, device=None):
        from ..utils.clip_bpe import tokenize

        if device is not None:
            self.embedding.to(device)
        toks = tokenize(list(texts), context_length=self.max_length, tokenizer=self.tokenizer)
        feats = self.embedding.encode_text(torch.from_numpy(toks["token"]))
        return feats, torch.from_numpy(toks["mask"]).float().to(feats.device)
