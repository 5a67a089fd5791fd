"""The Whisper family: ``whisper_tpu_torch``'s encoder–decoder, at the sizes
of its ``MODEL_DIMS`` table. A configuration file with no ``"family"`` key
is of this family.

* ``check``: the file's sizes (Hugging Face's keys) against the table's
  entry that ``program_model`` names;
* ``make_params``: ``common/weights.py``'s tree, drawn from the seed on
  the device in bfloat16;
* ``judge``: the float32 reference of ``reference/whisper.py`` at the
  configuration's ``reference`` rounding (int8 weights, e4m3 K/V) through
  ``reference/judge.py``, with the beam of the configuration's engine and
  the traffic's token budget; its control is the same reference at
  ``reference.control``, a precision below.
"""

from __future__ import annotations

from port_bench.common import weights
from port_bench.reference import judge as judge_mod
from port_bench.reference.whisper import Whisper


def check(config: dict) -> None:
    from whisper_tpu_torch.config import MODEL_DIMS

    dims = MODEL_DIMS[config["program_model"]]
    assert (dims.n_audio_state, dims.n_audio_layer, dims.n_text_layer, dims.n_audio_head,
            dims.n_mels, dims.n_vocab, dims.n_audio_ctx, dims.n_text_ctx) == (
        config["d_model"], config["encoder_layers"], config["decoder_layers"],
        config["encoder_attention_heads"], config["num_mel_bins"], config["vocab_size"],
        config["max_source_positions"], config["max_target_positions"])


def make_params(config: dict, seed: int, device) -> dict:
    return weights.make_params(config, seed, device)


def judge(run, items: list, control: bool = False) -> dict:
    ref = run.config["reference"]
    ctrl = Whisper(run.params, run.config, **ref["control"]) if control else None
    return judge_mod.judge(
        Whisper(run.params, run.config, weights=ref["weights"], kv=ref["kv"]), items, run.config,
        run.config["engine"]["beam_size"], run.traffic["max_new_tokens"], run.device, control=ctrl)
