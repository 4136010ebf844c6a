"""The CUDA kernel on the card: shapes beyond chip_smoke.py's, refusals,
and the launch count of a served request.

Marked ``cuda``; every test skips without a CUDA device (decided inside
the fixture, so every worker collects the same tests). On a machine
without JAX, run it without the repository's conftest:

    python -m pytest tests/test_torch_kernel_card.py --noconftest -q

Tolerances: f32 atol 1e-4 (summation order only); bf16 atol = rtol =
2e-2 (the plain version rounds probabilities and the output to bf16).
"""

import pytest
import torch

from k8s_gpu_device_plugin_torch.models.batching import ContinuousBatcher
from k8s_gpu_device_plugin_torch.models.llama import LlamaConfig, init_params
from k8s_gpu_device_plugin_torch.ops import kernel_support
from k8s_gpu_device_plugin_torch.ops import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0.0),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(b, t, hq, hkv, hd, s, dtype, seed=0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q = torch.randn((b, t, hq, hd), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((b, s, hkv, hd), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((b, s, hkv, hd), generator=gen, device="cuda", dtype=dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (24, 3), (64, 1)])
@pytest.mark.parametrize("t,window", [(1, 0), (3, 0), (17, 5), (65, 0),
                                      (300, 100)])
def test_kernel_matches_plain_version(cuda, dtype, hd, hq, hkv, t, window):
    s = 520  # not a multiple of the 64-row kv tile
    q, k, v = _inputs(3, t, hq, hkv, hd, s, dtype)
    base = torch.tensor([-1, 0, s - t], dtype=torch.int32, device=cuda)
    got = rpa.ragged_paged_attention(q, k, v, base, scale=hd ** -0.5,
                                     window=window)
    want = rpa.ragged_paged_attention_reference(q, k, v, base,
                                                scale=hd ** -0.5,
                                                window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernel_output_does_not_depend_on_the_other_slots(cuda):
    q, k, v = _inputs(4, 1, 32, 8, 128, 1024, torch.bfloat16)
    base = torch.tensor([700, 3, 1000, 64], dtype=torch.int32, device=cuda)
    both = rpa.ragged_paged_attention(q, k, v, base, scale=0.1)
    alone = rpa.ragged_paged_attention(q[2:3], k[2:3].contiguous(),
                                       v[2:3].contiguous(), base[2:3],
                                       scale=0.1)
    assert torch.equal(both[2:3], alone)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _inputs(2, 1, 8, 2, 128, 64, torch.bfloat16)
    base = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        rpa.ragged_paged_attention(q, k, v, base.long(), scale=1.0)
    with pytest.raises(ValueError, match="dtype"):
        rpa.ragged_paged_attention(q.half(), k.half(), v.half(), base,
                                   scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        rpa.ragged_paged_attention(q, k.transpose(0, 1).contiguous()
                                   .transpose(0, 1), v, base, scale=1.0)
    q96, k96, v96 = _inputs(2, 1, 8, 2, 96, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        rpa.ragged_paged_attention(q96, k96, v96, base, scale=1.0)


def test_served_requests_launch_the_kernel_per_layer(cuda):
    cfg = LlamaConfig.tiny(head_dim_override=64)
    cb = ContinuousBatcher(init_params(cfg, seed=1, device=cuda), cfg,
                           n_slots=2, max_len=128, chunked_prefill=16)
    for plen in (5, 40, 70):
        cb.submit(list(range(1, plen + 1)), max_new=6)
    kernel_support.reset_launch_counts()
    out = cb.run()
    assert all(len(toks) == 6 for toks in out.values())
    launches = kernel_support.launch_counts()["ragged_paged_attention"]
    assert launches == cfg.n_layers * (cb.decode_steps + cb.prefill_chunks)
