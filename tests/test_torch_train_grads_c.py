"""The port's LM gradients against the JAX package's, on the CPU: the
encoder-decoder and hymba. The ten archs are split over
``test_torch_train_grads_{a,b,c}.py`` so that the reference's compiles
spread over workers; the cases and tolerances are ``_lm_train.py``'s.
"""
import pytest
import torch

import _lm_train as LT

torch.set_num_threads(1)
ARCHS = ["seamless_m4t_medium", "hymba_1_5b"]


@pytest.mark.parametrize("arch,dtype", LT.arch_cases(ARCHS))
def test_gradients_match_the_reference(arch, dtype):
    LT.check_gradients(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_the_same_gradients(arch, monkeypatch):
    LT.check_remat(arch, monkeypatch)
