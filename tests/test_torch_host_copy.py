"""``utils/host_copy.py::to_host``: outputs off the card land in pinned
host tensors that own their storage, bitwise as a ``.cpu()`` would give
them; outputs already on the host (or on no device at all) pass through
as the same objects, uncounted. No JAX: on the card, ``python -m pytest
--noconftest -m cuda tests/test_torch_host_copy.py``."""
import pytest
import torch

from pavenet_tpu_torch.utils.host_copy import to_host


def outputs(device, seed):
    gen = torch.Generator().manual_seed(seed)
    out = dict(det_bboxes=torch.randn(2, 6, 5, generator=gen),
               det_labels=torch.randint(0, 80, (2, 6), generator=gen),
               det_masks=torch.rand(2, 6, 32, 48, generator=gen))
    return {k: v.to(device) for k, v in out.items()}


def counters():
    return to_host.copies, to_host.bytes


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_and_meta_outputs_pass_through_uncounted(device):
    out = outputs(device, 0)
    before = counters()
    got = to_host(out)
    assert got is out
    assert all(got[k] is v for k, v in out.items())
    assert counters() == before


@pytest.mark.cuda
def test_card_outputs_land_pinned_bitwise_and_owned():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    first, second = outputs("cuda", 1), outputs("cuda", 2)
    copies, nbytes = counters()
    a = to_host(first)
    held = {k: v.clone() for k, v in a.items()}
    b = to_host(second)
    assert counters() == (copies + 2, nbytes + sum(
        v.nbytes for v in list(first.values()) + list(second.values())))
    for got, src in ((a, first), (b, second)):
        assert set(got) == set(src)
        for k, v in got.items():
            assert v.device.type == "cpu" and v.is_pinned(), k
            assert v.dtype == src[k].dtype and v.shape == src[k].shape, k
            assert torch.equal(v, src[k].cpu()), k
    # each call's tensors own their storage: the second call wrote over
    # none of the first's
    ptrs = {v.untyped_storage().data_ptr() for v in a.values()}
    assert ptrs.isdisjoint(v.untyped_storage().data_ptr()
                           for v in b.values())
    for k, v in a.items():
        assert torch.equal(v, held[k]), k
