"""``loss_fn`` and its gradients against ``repro``'s for the hybrid
(RecurrentGemma: RG-LRU and local attention), ssm (RWKV6) and audio
(whisper's encoder-decoder) families, with ``test_torch_train_model.py``'s
check and bounds (that file holds the dense, moe and vlm families)."""
import pytest

from test_torch_train_model import check_family
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("family", ["hybrid", "ssm", "audio"])
def test_loss_and_grads_equal_repro(family):
    check_family(family)
