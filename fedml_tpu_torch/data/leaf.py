"""The LEAF Shakespeare character vocabulary (reference
shakespeare/language_utils.py:12-25), the port's copy of the helpers in
``fedml_tpu/data/leaf.py``: 86 symbols, and ``VOCAB_SIZE`` with pad, oov,
bos and eos on top."""

from __future__ import annotations

from typing import List

CHAR_VOCAB = list(
    "dhlptx@DHLPTX $(,048cgkoswCGKOSW[_#'/37;?bfjnrvzBFJNRVZ\"&*.26:"
    "\naeimquyAEIMQUY]!%)-159\r"
)
ALL_LETTERS = "".join(CHAR_VOCAB)
VOCAB_SIZE = len(ALL_LETTERS) + 4  # +pad/oov/bos/eos (language_utils.py:21)


def letter_to_index(letter: str) -> int:
    return ALL_LETTERS.find(letter)


def word_to_indices(word: str) -> List[int]:
    return [ALL_LETTERS.find(c) for c in word]
