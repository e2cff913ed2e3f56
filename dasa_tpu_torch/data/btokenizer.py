"""BERT wordpiece tokenizer for the Dic (cross-modal) path.

Counterpart of ``dasa_tpu/data/btokenizer.py``, a copy.

Behavioral match of the reference BTokenizer (r2r_src/utils.py:581-623):
[CLS] ... [SEP] framing, pad to encoding_length, SEP-overwrite
truncation.  Uses HF `transformers`; falls back to a local vocab file if
the hub is unreachable (zero-egress environments) — callers should catch
the RuntimeError and use the word Tokenizer instead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from dasa_tpu_torch.utils.vocab import split_sentence


class BTokenizer:
    split_sentence = staticmethod(split_sentence)

    def __init__(self, encoding_length: int = 20,
                 pretrained: str = "bert-base-uncased",
                 vocab_file: Optional[str] = None):
        try:
            from transformers import BertTokenizer

            if vocab_file is not None:
                self.tokenizer = BertTokenizer(vocab_file=vocab_file)
            else:
                self.tokenizer = BertTokenizer.from_pretrained(pretrained)
        except Exception as e:  # offline / no cached vocab
            raise RuntimeError(
                f"BERT tokenizer unavailable ({e}); pass vocab_file or "
                "use the word-level Tokenizer") from e
        self.encoding_length = encoding_length
        self.pad_token_id = self.tokenizer.pad_token_id
        self.sep_token_id = self.tokenizer.sep_token_id
        # expose the word_to_index interface the agents use
        self.word_to_index = {
            "<PAD>": self.tokenizer.pad_token_id,
            "<EOS>": self.tokenizer.sep_token_id,
            "<BOS>": self.tokenizer.cls_token_id,
            "<UNK>": self.tokenizer.unk_token_id,
        }

    def encode_sentence(self, sentence: str,
                        max_length: Optional[int] = None) -> np.ndarray:
        max_length = max_length or self.encoding_length
        encoding = self.tokenizer.encode(f"[CLS] {sentence} [SEP]",
                                         add_special_tokens=False)
        if len(encoding) < max_length:
            encoding += [self.pad_token_id] * (max_length - len(encoding))
        elif len(encoding) > max_length:
            encoding[max_length - 1] = self.sep_token_id
        return np.array(encoding[:max_length])

    def decode_sentence(self, encoding: Sequence[int]) -> str:
        enc = [int(t) for t in encoding if int(t) != self.pad_token_id]
        return self.tokenizer.decode(enc)

    def shrink(self, inst: Sequence[int]) -> List[int]:
        inst = list(inst)
        if inst and inst[0] == self.tokenizer.cls_token_id:
            inst = inst[1:]
        if self.sep_token_id in inst:
            inst = inst[: inst.index(self.sep_token_id)]
        return inst

    def vocab_size(self) -> int:
        return len(self.tokenizer)

    def __len__(self) -> int:
        return len(self.tokenizer)
