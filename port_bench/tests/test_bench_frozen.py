"""Each frozen copy in common/frozen.py equals its source in the program,
as that source stood at commit 615005eb77ca2a10f5d8d42dcb9e64044e44f265."""

import numpy as np
import pytest

from port_bench.common import frozen


def test_make_batch_equals_bench():
    from whisper_tpu_torch.utils import bench

    for rows, secs in ((4, 30.0), (3, 7.5)):
        np.testing.assert_array_equal(frozen.make_batch(rows, secs, seed=1),
                                      bench.make_batch(rows, secs))


def test_utterances_equal_bench_serving():
    from whisper_tpu_torch.utils import bench_serving

    for a, b in zip(frozen.utterances(5, seed=0), bench_serving.utterances(5)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["large-v3", "large-v3-turbo", "tiny"])
@pytest.mark.parametrize("crop", [None, 512])
def test_flops_equal_roofline(model, crop):
    import dataclasses

    from whisper_tpu_torch.config import MODEL_DIMS
    from whisper_tpu_torch.utils import roofline

    d = MODEL_DIMS[model]
    dd = d if crop is None else dataclasses.replace(d, n_audio_ctx=crop)
    tk = crop or d.n_audio_ctx
    assert frozen.encoder_flops(d.n_mels, d.n_audio_state, d.n_audio_layer, d.n_audio_ctx,
                                16) == roofline.encoder_flops(d, 16)
    assert frozen.cross_kv_flops(d.n_text_state, d.n_text_layer, tk, 16) == \
        roofline.cross_kv_flops(dd, 16)
    assert frozen.decoder_flops(d.n_text_state, d.n_text_layer, d.n_vocab, tk, 80, 4, 223.0) == \
        roofline.decoder_flops(dd, 80, 4, 223.0)
