from transformertts_tpu_torch.text.symbols import (  # noqa: F401
    SYMBOLS,
    PHONEMES,
    PUNCTUATION,
    symbol_to_id,
    phoneme_to_sequence,
    sequence_to_phoneme,
)
from transformertts_tpu_torch.text.g2p import G2p, phonemize  # noqa: F401
