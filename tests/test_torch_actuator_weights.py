"""The actuator network's weight path (models/actuator_net.py): a TorchScript
network's weights extracted to arrays, saved as JSON and loaded as tensors.

The repository holds no TorchScript file, so the test scripts a synthetic
network of the reference's shape (``out_scale * linear(lstm(in_scale *
x))``: 2 inputs, a 2-layer LSTM of 8, a linear head, ``in_scale`` (2.0,
0.25) and ``out_scale`` 20 as buffers; weights from a numpy seed) and saves
it with ``torch.jit.save``.  Extracting it gives the JAX package's arrays
exactly; loaded through ``load_weights_json``, the network equals
``from_json`` of the same file bit for bit and the JAX ``ActuatorNetLSTM``
on the same weights over 10 carried steps at 1e-6 (hidden state) and 1e-6
times the output scale (torque), and the scripted network's own forward at
1e-5 times the output scale (torch's fused LSTM sums in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from extended_legged_gym_tpu.models import actuator_net as jactuator_net
from extended_legged_gym_tpu_torch.models import actuator_net
from extended_legged_gym_tpu_torch.models.actuator_net import ActuatorNetLSTM

E, NJ, HIDDEN, LAYERS, OUT_SCALE = 4, 12, 8, 2, 20.0


class _SeaNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.lstm = nn.LSTM(2, HIDDEN, num_layers=LAYERS, batch_first=True)
        self.linear = nn.Linear(HIDDEN, 1)
        self.register_buffer("in_scale", torch.tensor([2.0, 0.25]))
        self.register_buffer("out_scale", torch.tensor(OUT_SCALE))

    def forward(self, x, h0, c0):
        y, (h, c) = self.lstm(x * self.in_scale, (h0, c0))
        return self.linear(y) * self.out_scale, h, c


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    net = _SeaNet()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.as_tensor(0.5 * rng.standard_normal(p.shape).astype(np.float32)))
    path = tmp_path_factory.mktemp("sea") / "sea_lstm.pt"
    torch.jit.save(torch.jit.script(net), str(path))
    return str(path)


@pytest.fixture(scope="module")
def weights_json(scripted, tmp_path_factory):
    path = tmp_path_factory.mktemp("sea_json") / "sea_lstm.json"
    actuator_net.save_weights_json(actuator_net.extract_weights(scripted), str(path))
    return str(path)


def test_extract_weights_matches_jax(scripted):
    got, want = actuator_net.extract_weights(scripted), jactuator_net.extract_weights(scripted)
    assert sorted(got) == sorted(want)
    assert {"lstm.weight_ih_l1", "linear.weight", "in_scale", "out_scale"} <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["out_scale"].shape == (1,)


def test_load_weights_json_gives_tensors_on_the_device(weights_json):
    w = actuator_net.load_weights_json(weights_json, device="cpu")
    jw = jactuator_net.load_weights_json(weights_json)
    assert sorted(w) == sorted(jw)
    for k, v in w.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32 and v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), np.asarray(jw[k]), err_msg=k)


def test_round_trip_net_matches_from_json_jax_and_the_scripted_net(scripted, weights_json):
    net = ActuatorNetLSTM(actuator_net.load_weights_json(weights_json))
    ref = ActuatorNetLSTM.from_json(weights_json)
    jnet = jactuator_net.ActuatorNetLSTM.from_json(weights_json)
    ts = torch.jit.load(scripted)
    assert (net.num_layers, net.hidden) == (jnet.num_layers, jnet.hidden) == (LAYERS, HIDDEN)
    rng = np.random.default_rng(1)
    h, rh, jh = net.init_hidden((E, NJ)), ref.init_hidden((E, NJ)), jnet.init_hidden((E, NJ))
    th = torch.zeros(LAYERS, E * NJ, HIDDEN), torch.zeros(LAYERS, E * NJ, HIDDEN)
    for _ in range(10):
        x = (rng.standard_normal((E, NJ, 2)) * [0.3, 4.0]).astype(np.float32)
        tau, h = net(torch.as_tensor(x), h)
        rtau, rh = ref(torch.as_tensor(x), rh)
        jtau, jh = jnet(jnp.asarray(x), jh)
        with torch.no_grad():
            ttau, *th = ts(torch.as_tensor(x).reshape(E * NJ, 1, 2), *th)
        assert torch.equal(tau, rtau) and all(torch.equal(a, b) for a, b in zip(h, rh))
        np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), atol=OUT_SCALE * 1e-6)
        for a, b in zip(h, jh):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        np.testing.assert_allclose(tau.numpy(), ttau.reshape(E, NJ).numpy(),
                                   atol=OUT_SCALE * 1e-5)
    assert float(h[1].abs().max()) > 0.1        # the cell state moved
