"""The port's `core/memory.py` against the JAX package's: the layer streamer
(`stream_layer_forward`) on a layer stack held on the host, and the
`AsyncMemoryManager` behaviours the JAX tests check (the budget's LRU
eviction, `exclusive`, values surviving the round trip, a resident `use()`
evicting nothing), on the CPU. The streamer's card path (pinned host
buffers, a side stream, events) runs in `chip_smoke.py` phase 16."""
import jax.numpy as jnp
import numpy as np
import torch

from inferix_tpu.core import memory as jmem
from inferix_tpu_torch.core import memory as tmem


def _stack(rng, layers=4, d=8):
    return {"w": rng.standard_normal((layers, d, d)).astype(np.float32),
            "b": {"v": rng.standard_normal((layers, d)).astype(np.float32)}}


def test_stream_layer_forward_against_jax():
    """The same stack and layer function through both streamers: equal to
    1e-6, and equal bit for bit to the port's own resident loop."""
    rng = np.random.default_rng(0)
    blocks = _stack(rng)
    x0 = rng.standard_normal((3, 8)).astype(np.float32)

    def jlayer(x, blk):
        return jnp.tanh(x @ blk["w"] + blk["b"]["v"])

    def tlayer(x, blk):
        return torch.tanh(x @ blk["w"] + blk["b"]["v"])

    want = jmem.stream_layer_forward(blocks, jlayer, jnp.asarray(x0))
    host = tmem.tree_map(torch.from_numpy, blocks)
    for prefetch in (1, 2, 3, 8):
        got = tmem.stream_layer_forward(host, tlayer, torch.from_numpy(x0), device="cpu",
                                        prefetch=prefetch)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    resident = torch.from_numpy(x0)
    for i in range(4):
        resident = tlayer(resident, tmem.tree_map(lambda a: a[i], host))
    assert torch.equal(got, resident)


def test_stream_layer_forward_empty_stack():
    x = torch.ones(2)
    assert tmem.stream_layer_forward({}, lambda c, b: c + 1, x, device="cpu") is x


def test_memory_manager_budget_lru():
    """JAX tests/test_media_memory.py:56 on the port: a budget of 3 MB
    evicts the least recently used components for a 2 MB one; exclusive()
    leaves one resident; values survive."""
    mb = 1024 * 1024
    mgr = tmem.AsyncMemoryManager(budget_bytes=3 * mb, device="cpu")
    jm = jmem.AsyncMemoryManager(budget_bytes=3 * mb)
    for name in "abc":
        mgr.register(name, torch.zeros(mb // 4))
        jm.register(name, jnp.zeros((mb // 4,), jnp.float32))
    assert mgr.device_bytes() == jm.device_bytes() == 3 * mb
    big = torch.arange(mb // 2, dtype=torch.float32)
    mgr.register("big", big)
    jm.register("big", jnp.asarray(big.numpy()))
    with mgr.use("big") as t, jm.use("big"):
        assert t.shape == big.shape
    assert mgr.device_bytes() <= 3 * mb
    assert ({n: c.on_device for n, c in mgr._components.items()}
            == {n: c.on_device for n, c in jm._components.items()})
    with mgr.exclusive("a"):
        assert [n for n, c in mgr._components.items() if c.on_device] == ["a"]
    assert torch.equal(mgr.get("big"), big)


def test_memory_manager_resident_use_does_not_evict():
    """JAX tests/test_cfg_and_misc.py:296 on the port: use() of a resident
    component counts no new bytes, so it evicts nothing."""
    mb = 1024 * 1024
    mgr = tmem.AsyncMemoryManager(budget_bytes=16 * mb, device="cpu")
    mgr.register("gen", {"w": torch.zeros(9 * mb // 4)})
    mgr.register("text", {"w": torch.zeros(3 * mb // 4)})
    for name in ("gen", "text", "gen"):
        with mgr.use(name):
            pass
    assert mgr._components["gen"].on_device and mgr._components["text"].on_device


def test_memory_manager_offload_callback():
    """offload / prefetch move the component and hand the moved tree to its
    owner's callback."""
    seen = []
    mgr = tmem.AsyncMemoryManager(device="cpu")
    mgr.register("vae", {"w": torch.ones(4)}, on_update=seen.append)
    mgr.offload("vae")
    assert not mgr._components["vae"].on_device and mgr.device_bytes() == 0
    mgr.prefetch("vae")
    assert mgr._components["vae"].on_device and mgr.device_bytes() == 16
    assert len(seen) == 2 and torch.equal(seen[-1]["w"], torch.ones(4))


def test_tree_helpers():
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), {"c": torch.ones(3)}]}
    assert [x.numel() for x in tmem.tree_leaves(tree)] == [2, 1, 3]
    doubled = tmem.tree_map(lambda x: x * 2, tree)
    assert torch.equal(doubled["b"][1]["c"], torch.full((3,), 2.0))
    assert tmem._tree_bytes(tree) == 24
