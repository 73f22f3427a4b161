"""The port's token pipeline against ``repro/data/tokens.py``.

``synth_batch`` must give bitwise the reference's arrays for any (seed,
step), so the two packages train on the same tokens; ``TokenStream``
yields them in order from ``start_step``, on the device asked for, and a
stream restarted at a step yields what the first stream did there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import tokens as jtokens  # noqa: E402
from repro_torch.data import tokens as ttokens  # noqa: E402


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (11, 123),
                                       (2 ** 31 - 1, 5)])
@pytest.mark.parametrize("prefix", [0, 4])
def test_synth_batch_is_bitwise_the_reference(seed, step, prefix):
    kw = dict(vocab_size=517, seq_len=37, global_batch=3, seed=seed,
              prefix_len=prefix, d_model=8 if prefix else 0)
    ours = ttokens.synth_batch(ttokens.TokenDataConfig(**kw), step)
    ref = jtokens.synth_batch(jtokens.TokenDataConfig(**kw), step)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == \
            ref[k].shape
        np.testing.assert_array_equal(ours[k], ref[k])


def test_token_stream_yields_the_steps_in_order_and_resumes():
    cfg = ttokens.TokenDataConfig(vocab_size=100, seq_len=16, global_batch=2,
                                  seed=4)
    stream = ttokens.TokenStream(cfg, device="cpu")
    try:
        first = [next(stream) for _ in range(5)]
    finally:
        stream.close()
    assert stream.step == 5
    for i, b in enumerate(first):
        want = ttokens.synth_batch(cfg, i)
        for k, v in want.items():
            assert b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), v)
    again = ttokens.TokenStream(cfg, start_step=3, device="cpu")
    try:
        resumed = [next(again) for _ in range(2)]
    finally:
        again.close()
    for a, b in zip(resumed, first[3:]):
        for k in a:
            assert torch.equal(a[k], b[k])


def test_token_stream_needs_a_device_or_a_card():
    cfg = ttokens.TokenDataConfig(vocab_size=10, seq_len=4, global_batch=1)
    if torch.cuda.is_available():
        pytest.skip("there is a card: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttokens.TokenStream(cfg)
