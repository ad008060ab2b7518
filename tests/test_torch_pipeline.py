"""The port's token pipeline (``repro_torch.data.pipeline``): batches
byte-identical to ``repro``'s over seeds x groups, ``tests/test_data.py``'s
four token-pipeline cases, and ``shard_batch``'s rows per rank."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as RPipeline
from repro_torch.data.pipeline import TokenPipeline, shard_batch
from repro_torch.launch.mesh import HostMesh


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_batches_byte_identical_to_repro(seed, groups):
    kw = dict(vocab_size=1000, seq_len=48, global_batch=8, seed=seed,
              num_groups=groups)
    ours, ref = TokenPipeline(**kw), RPipeline(**kw)
    assert ours.motifs.tobytes() == ref.motifs.tobytes()
    for a, b in zip(ours.batches(3), ref.batches(3)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes()


def test_token_pipeline_shapes():
    p = TokenPipeline(vocab_size=1000, seq_len=64, global_batch=8,
                      num_groups=4)
    batch = next(p.batches())
    assert batch["tokens"].shape == (8, 64)
    assert batch["labels"].shape == (8, 64)
    assert batch["tokens"].dtype == np.int32
    assert batch["tokens"].max() < 1000


def test_token_pipeline_label_shift():
    p = TokenPipeline(vocab_size=500, seq_len=32, global_batch=4)
    b = next(p.batches())
    assert b["tokens"].shape == b["labels"].shape
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_token_pipeline_groups_nontrivially_different():
    p = TokenPipeline(vocab_size=1000, seq_len=128, global_batch=4,
                      num_groups=2, seed=0)
    assert not np.array_equal(p.motifs[0], p.motifs[1])


def test_token_pipeline_num_steps():
    p = TokenPipeline(vocab_size=100, seq_len=16, global_batch=2)
    assert len(list(p.batches(num_steps=3))) == 3


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_shard_batch_takes_this_ranks_rows(rank):
    batch = next(TokenPipeline(vocab_size=100, seq_len=16, global_batch=8,
                               num_groups=4).batches())
    batch["frames"] = np.ones((8, 3, 5), np.float32)
    mesh = HostMesh(("data", "model"), (4, 1), rank, torch.device("cpu"))
    out = shard_batch(batch, mesh)
    assert out["tokens"].dtype == torch.int64
    assert out["frames"].dtype == torch.float32
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  batch["tokens"][2 * rank:2 * rank + 2])
    np.testing.assert_array_equal(out["labels"].numpy(),
                                  batch["labels"][2 * rank:2 * rank + 2])
