"""Tiny HuggingFace text models written to a local directory, for the tests
of the `transformers` text encoders (`CLIPTextEncoder`, `BERTTextEncoder`)
of both packages: a 2-layer CLIP text model of width 16 with a CLIP
tokenizer over single letters and the caption words (no merges), and a
2-layer BERT of width 16 with a word-piece vocabulary of the same words.
Weights are torch's default init under `torch.manual_seed(seed)`.

    clip_dir, bert_dir = write_tiny_hf_models(directory)
"""
import json
import os

WORDS = ["a", "red", "cat", "on", "the", "grass", "blue", "dog"]


def write_tiny_hf_models(directory, seed=0):
    os.environ.setdefault("USE_TF", "0")  # as the encoders do: no TensorFlow / Flax
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from transformers import (BertConfig, BertModel, BertTokenizer, CLIPTextConfig,
                              CLIPTextModel, CLIPTokenizer)

    directory = str(directory)
    clip_dir, bert_dir = os.path.join(directory, "clip"), os.path.join(directory, "bert")
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    vocab = ["!", "<|startoftext|>", "<|endoftext|>", *letters, *(c + "</w>" for c in letters),
             *(w + "</w>" for w in WORDS)]
    vocab_json, merges = os.path.join(directory, "vocab.json"), os.path.join(directory,
                                                                           "merges.txt")
    with open(vocab_json, "w") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f)
    with open(merges, "w") as f:
        f.write("#version: 0.2\n")
    CLIPTokenizer(vocab_json, merges).save_pretrained(clip_dir)
    torch.manual_seed(seed)
    CLIPTextModel(CLIPTextConfig(
        vocab_size=len(vocab), hidden_size=16, intermediate_size=32, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=77, bos_token_id=1, eos_token_id=2,
        pad_token_id=2)).save_pretrained(clip_dir)

    vocab_txt = os.path.join(directory, "vocab.txt")
    with open(vocab_txt, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *WORDS]) + "\n")
    BertTokenizer(vocab_txt).save_pretrained(bert_dir)
    BertModel(BertConfig(vocab_size=5 + len(WORDS), hidden_size=16, intermediate_size=32,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=80)).save_pretrained(bert_dir)
    return clip_dir, bert_dir
