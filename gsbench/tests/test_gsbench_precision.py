"""The reference's precision switch leaves the process as it found it:
the program's TF32 setting is the program's."""
import torch

from gsbench.reference import precision


def test_tf32_switch_restores():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with precision.tf32(True):
        assert torch.backends.cuda.matmul.allow_tf32
        with precision.tf32(False):
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
