"""The port's CUDA kernels against their plain versions on the card, at
edge shapes the serving path's smoke run does not reach (scalar-load path,
wide rows, odd group sizes, strided cache views), and the engine on the
card against the engine on the CPU.

Every test needs an NVIDIA card and nvcc and skips without one. On a
machine with a card (no JAX needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

from ray_tpu_torch.ops import attention, fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


@pytest.mark.parametrize("R,E,dtype", [
    (1, 1024, torch.float32), (3, 1001, torch.float32),
    (5, 1001, torch.bfloat16), (7, 4096, torch.bfloat16),
    (2, 8192, torch.float32), (300, 2048, torch.bfloat16),
])
def test_rms_norm_kernel_matches_plain(dev, R, E, dtype):
    g = _gen(R + E)
    x = torch.randn(R, E, generator=g, device=dev).to(dtype)
    w = (1 + 0.1 * torch.randn(E, generator=g, device=dev)).to(dtype)
    got = fused.rms_norm(x, w, 1e-5)
    tol = (dict(atol=1e-6, rtol=1e-5) if dtype == torch.float32
           else dict(atol=2e-2, rtol=2e-2))
    torch.testing.assert_close(got.float(),
                               fused._rms_norm_ref(x, w, 1e-5).float(), **tol)


def test_rms_norm_kernel_unaligned_rows_take_scalar_loads(dev):
    flat = torch.randn(1 + 4 * 64, generator=_gen(1), device=dev)
    x = flat[1:].view(4, 64)            # contiguous, 4 bytes off 16
    w = torch.ones(64, device=dev)
    torch.testing.assert_close(fused.rms_norm(x, w, 1e-5),
                               fused._rms_norm_ref(x, w, 1e-5), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("B,H,KH,D,S,lengths", [
    (2, 6, 2, 128, 100, [99, 0]),        # G = 3, S not a tile multiple
    (3, 4, 4, 64, 65, [63, 64, 1]),      # tile edges
    (1, 16, 1, 64, 300, [200]),          # MQA, G = 16
])
def test_decode_kernel_matches_plain_f32(dev, B, H, KH, D, S, lengths):
    g = _gen(S)
    q = torch.randn(B, H, D, generator=g, device=dev)
    # Strided views: rows of a wider pool, as a layer slice of the cache.
    pool_k = torch.randn(2, B, S + 7, KH, D, generator=g, device=dev)
    pool_v = torch.randn(2, B, S + 7, KH, D, generator=g, device=dev)
    k, v = pool_k[1, :, :S], pool_v[1, :, :S]
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        attention.decode_attention(q, k, v, lens),
        attention._decode_attention_ref(q, k, v, lens), atol=2e-5, rtol=0)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.randn(4, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fused.rms_norm(x, torch.ones(64, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        fused.rms_norm(torch.randn(64, 4, device=dev).t(),
                       torch.ones(64, device=dev))
    q = torch.randn(1, 2, 96, device=dev)
    k = torch.randn(1, 8, 2, 96, device=dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="D in"):
        attention.decode_attention(q, k, k, lens)
    q, k = torch.randn(1, 2, 64, device=dev), torch.randn(1, 8, 2, 64,
                                                         device=dev)
    with pytest.raises(TypeError, match="int32"):
        attention.decode_attention(q, k, k, lens.long())


def test_engine_on_card_matches_engine_on_cpu_f32(dev):
    from ray_tpu_torch.models import TransformerConfig, init_params
    from ray_tpu_torch.models.engine import GenerationEngine

    cfg = TransformerConfig(vocab_size=256, d_model=128, n_layers=2,
                            n_heads=2, n_kv_heads=1, d_ff=256,
                            max_seq_len=128, dtype=torch.float32)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompts = [[1, 2, 3], [7, 8, 9, 10, 11], [4], [20, 21, 22, 23]]
    outs = []
    for device in ("cpu", "cuda"):
        eng = GenerationEngine(params, cfg, max_slots=3, device=device)
        ids = [eng.submit(p, 6) for p in prompts]
        res = eng.run_until_done()
        outs.append([res[i] for i in ids])
    assert outs[0] == outs[1]
