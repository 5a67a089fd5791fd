"""The benchmark's own tests (run with ``python -m pytest port_bench/tests``).
A test that needs the card is marked ``cuda`` and decides inside the test
whether there is one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(program_model="tiny", d_model=384, encoder_layers=4, decoder_layers=4,
            encoder_attention_heads=6, decoder_attention_heads=6, encoder_ffn_dim=1536,
            decoder_ffn_dim=1536, num_mel_bins=80, vocab_size=51865)
