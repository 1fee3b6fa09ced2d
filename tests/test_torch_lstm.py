"""The port's LSTM baseline against the JAX package's flax one: the
windows, the forward on flax parameters carried across by
``convert.lstm_params_from_flax``, the flax initial values, training on
JAX's own permutations (two epochs, the second's last batch padded and
masked) and the forecast on JAX's own normals.

Tolerances: the forward rtol 1e-5 (float32 gates in two libraries);
training rtol 1e-4 (a few optax-exact Adam steps on float32 gradients);
the forecast rtol 1e-5 on JAX's trained parameters, 1e-4 through the
port's own training.  Inputs stay small (hidden <= 8, 2 epochs): JAX's
``jit`` of the training loop dominates otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import close, j32, jax_tree_np, t32

from volt_tpu.models import lstm as jl

from volt_tpu_torch.convert import lstm_params_from_flax
from volt_tpu_torch.data import sabr_paths
from volt_tpu_torch.models import LSTM, lstm as tl

SEQ, HIDDEN = 5, 8


@pytest.fixture(scope="module")
def series():
    f, _ = sabr_paths(steps=70, seed=11)
    return np.log(f).astype(np.float32)


def test_make_windows(series):
    jw, jt = jl.make_windows(j32(series), SEQ)
    w, t = tl.make_windows(t32(series), SEQ)
    close(w, jw, 0.0)
    close(t, jt, 0.0)
    w, t = tl.make_windows(t32([1.0, 2.0, 3.0, 4.0]), 3)
    close(w, [[1, 1, 1], [1, 1, 2], [1, 2, 3]], 0.0)  # left-padded


@pytest.mark.parametrize("layers", [1, 2])
def test_forward_on_flax_params(layers):
    net = jl._Net(HIDDEN, layers)
    x = np.random.default_rng(0).standard_normal((7, SEQ)).astype(np.float32)
    params = net.init(jax.random.key(2), j32(x[:2]))["params"]
    # off the zero biases, so the converted biases matter
    params = jax.tree.map(lambda a: a + 0.05, params)
    want = net.apply({"params": params}, j32(x))
    tnet = tl._Net(SEQ, HIDDEN, layers)
    tnet.load_state_dict(lstm_params_from_flax(jax_tree_np(params)))
    close(tnet(t32(x)), want, 1e-5, 1e-6)


def test_init_as_flax():
    """flax's initial values: zero biases, orthogonal recurrent blocks per
    gate, lecun-normal kernels truncated at two standard deviations; the
    input biases stay out of training."""
    tnet = tl._Net(40, 32, 2).init_flax(torch.Generator().manual_seed(0))
    for layer, fan_in in ((0, 40), (1, 32)):
        w_ih = getattr(tnet.lstm, f"weight_ih_l{layer}").detach()
        w_hh = getattr(tnet.lstm, f"weight_hh_l{layer}").detach()
        for gate in range(4):
            blk = w_hh[gate * 32:(gate + 1) * 32]
            close(blk @ blk.T, np.eye(32), 0.0, 1e-5)
        std = np.sqrt(1.0 / fan_in) / tl._TRUNC_STD
        assert float(w_ih.abs().max()) <= 2 * std
        assert abs(float(w_ih.std()) / np.sqrt(1.0 / fan_in) - 1) < 0.1
        for side in ("ih", "hh"):
            assert not getattr(tnet.lstm, f"bias_{side}_l{layer}").any()
        assert not getattr(tnet.lstm, f"bias_ih_l{layer}").requires_grad
    assert not tnet.dense0.bias.any() and not tnet.dense1.bias.any()
    # flax's own draw of the same tree has the same layout
    flax = jl._Net(32, 2).init(jax.random.key(0), jnp.ones((2, 40)))
    assert set(lstm_params_from_flax(jax_tree_np(flax["params"]))) == \
        set(tnet.state_dict())


def _jax_train(series, epochs, batch):
    """JAX's ``_train`` and the initial tree and permutations it drew (its
    key recipe: ``(k_init, key)``, then one key per epoch)."""
    key = jax.random.key(5)
    out = jl._train(key, j32(series), SEQ, HIDDEN, 1, epochs, batch, 0.01)
    k_init, key = jax.random.split(key)
    n = series.shape[-1] - 1
    windows, _ = jl.make_windows(j32(series), SEQ)
    init = jl._Net(HIDDEN, 1).init(k_init, windows[:2])["params"]
    perms = np.stack([np.asarray(jax.random.permutation(k, n))
                      for k in jax.random.split(key, epochs)])
    return out, init, perms


def test_training_on_jax_permutations(series):
    """Two epochs of batch 32 on 69 windows: ``ceil`` gives 3 batches, the
    last padded by -1 and masked out of the summed NLL."""
    (params, mean, std, last, losses), init, perms = _jax_train(series, 2, 32)
    tnet = tl._Net(SEQ, HIDDEN, 1)
    tnet.load_state_dict(lstm_params_from_flax(jax_tree_np(init)))
    got = tl._train(tnet, t32(series), SEQ, 2, 32, 0.01, None,
                    torch.as_tensor(perms))
    close(got[0], mean, 1e-6)
    close(got[1], std, 1e-6)  # ddof=1
    # the normalised window divides a float32 difference by a small std
    close(got[2], last, 1e-5)
    close(got[3], losses, 1e-4)
    want = lstm_params_from_flax(jax_tree_np(params))
    for name, p in tnet.state_dict().items():
        close(p, want[name], 1e-4, 1e-5)


def test_forecast_on_jax_normals(series):
    """The forecast on JAX's draws (one key per step, ``normal(k, (S,))``),
    from JAX's trained state and through ``train_lstm`` on JAX's initial
    tree and permutations."""
    (params, mean, std, last, _), init, perms = _jax_train(series, 2, 32)
    jstate = jl.LSTMState(params=params, train_mean=mean, train_std=std,
                          last_window=last, config=(SEQ, HIDDEN, 1))
    key, h, s = jax.random.key(9), 6, 12
    want = jstate.forecast(key, h, s)
    zs = t32(np.stack([np.asarray(jax.random.normal(k, (s,)))
                       for k in jax.random.split(key, h)])).T
    tnet = tl._Net(SEQ, HIDDEN, 1)
    tnet.load_state_dict(lstm_params_from_flax(jax_tree_np(params)))
    state = tl.LSTMState(net=tnet, train_mean=t32(mean), train_std=t32(std),
                         last_window=t32(last), config=(SEQ, HIDDEN, 1))
    close(state.forecast(None, h, s, zs=zs), want, 1e-5)
    trained = tl.train_lstm(series, SEQ, HIDDEN, 1, 2, 32, device="cpu",
                            init_params=jax_tree_np(init),
                            perms=torch.as_tensor(perms))
    close(trained.forecast(None, h, s, zs=zs), want, 1e-4)


def test_own_draws_and_the_wrapper(series):
    """``train_lstm`` draws its init and permutations from the generator:
    the same seed gives the same forecast; the reference-style wrapper
    forecasts the test grid's length."""
    def run(seed):
        st = tl.train_lstm(t32(series), SEQ, HIDDEN, 1, 2, 32,
                           generator=torch.Generator().manual_seed(seed))
        return st.forecast(torch.Generator().manual_seed(1), 4, 6)

    a, b, c = run(0), run(0), run(1)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c) and torch.isfinite(a).all()
    model = LSTM(None, t32(series), seq_len=SEQ, hidden_size=HIDDEN,
                 num_layers=1, batch_size=32)
    with pytest.raises(RuntimeError, match="Train"):
        model.Forecast(torch.zeros(3))
    model.Train(1)
    out = model.Forecast(torch.zeros(3), nsample=5)
    assert out.shape == (5, 3) and torch.isfinite(out).all()
