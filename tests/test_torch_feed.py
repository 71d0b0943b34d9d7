"""The port's BatchFeed lifecycle: exhaustion, early abandonment, a producer
error, and the stacking contract, as tests/test_feed.py holds the JAX
package's feeds.

On a CPU device the feed is a plain iterator (no producer thread): it
delivers every batch in order, pulls no batch the consumer did not ask for,
and raises the producer's error after the batches before it.  The threaded
staging onto the card (pinned buffers, a side stream) is held to the same
lifecycle by the card-only tests in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from stereoslam_tpu_torch.utils.feed import BatchFeed

B, H, W = 3, 8, 12


def _batches(n, pulled=None):
    for t in range(n):
        if pulled is not None:
            pulled.append(t)
        yield (np.full((B, H, W), t, np.float64), np.full((B, H, W), 100 + t, np.float64),
               np.full(B, t * 0.1))


def test_batch_feed_stacks_uint8():
    n = 0
    for t, (lr, ts) in enumerate(BatchFeed(_batches(5), depth=2, device="cpu")):
        assert lr.shape == (B, 2, H, W) and lr.dtype == torch.uint8
        assert isinstance(ts, np.ndarray) and ts.shape == (B,) and ts.dtype == np.float32
        assert (lr[:, 0] == t).all() and (lr[:, 1] == 100 + t).all()
        np.testing.assert_array_equal(ts, np.float32(t * 0.1))
        n += 1
    assert n == 5


def test_batch_feed_full_drain_terminates():
    seen = [int(lr[0, 0, 0, 0]) for lr, _ in BatchFeed(_batches(10), depth=2, device="cpu")]
    assert seen == list(range(10))


def test_batch_feed_early_break_pulls_no_more():
    pulled = []
    feed = BatchFeed(_batches(100, pulled), depth=2, device="cpu")
    for i, _ in enumerate(feed):
        if i == 3:
            break
    feed.close()
    assert pulled == [0, 1, 2, 3]


def test_batch_feed_propagates_producer_error():
    def bad():
        yield from _batches(2)
        raise RuntimeError("disk died")

    got = []
    with pytest.raises(RuntimeError, match="disk died"):
        for _, ts in BatchFeed(bad(), depth=2, device="cpu"):
            got.append(ts)
    assert len(got) == 2


def test_batch_feed_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchFeed(_batches(1))
