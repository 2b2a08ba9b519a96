"""`psa_torch.utils.sweep_ab` on the CPU: its usage and its refusal
without a card, and the digest it compares trees by."""

import numpy as np
import torch

from psa_torch.utils import sweep_ab


def test_usage_and_no_card(capsys):
    assert sweep_ab.main([]) == 2
    assert "TREE" in capsys.readouterr().err
    assert sweep_ab.main(["."]) == 2


def test_digest_tells_outputs_apart():
    a = torch.from_numpy(np.arange(10, dtype=np.int32))
    b = a.clone()
    assert sweep_ab.digest(a) == sweep_ab.digest(b)
    b[3] += 1
    assert sweep_ab.digest(a) != sweep_ab.digest(b)
