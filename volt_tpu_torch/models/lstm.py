"""The LSTM forecasting baseline (port of :mod:`volt_tpu.models.lstm`).

Reference ``models/LSTM.py``: sliding windows of the normalised series
(left-padded with its first value); a stacked LSTM that takes the *whole
window* as the features of a single timestep (the reference's quirk: the
window length is the LSTM's ``input_size``, the sequence length is 1 and
the carry starts at zero); ReLU, Dense 128, ReLU, Dense 2, whose second
output goes through softplus as the std; the summed Gaussian NLL under
Adam; and an autoregressive sampling forecast.

The LSTM is ``torch.nn.LSTM`` with the JAX package's flax
``OptimizedLSTMCell`` parameterisation: one bias per gate, the hidden
one (``bias_hh``); ``bias_ih`` stays zero and is not trained.  The initial
values follow flax: ``lecun_normal`` input and Dense kernels,
``orthogonal`` recurrent kernels per gate, zero biases
(:func:`volt_tpu_torch.convert.lstm_params_from_flax` carries a flax tree
across).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from ..optim import Adam

__all__ = ["LSTMModel", "LSTMState", "make_windows", "train_lstm"]

_TRUNC_STD = 0.87962566103423978  # std of a standard normal cut at +-2


def make_windows(y, seq_len: int):
    """Sliding windows ending at each index, left-padded with ``y[0]``:
    ``(windows (..., N-1, seq_len), targets (..., N-1))``; window ``i``
    ends at ``y[i]`` and predicts ``y[i+1]`` (reference
    ``SequenceDataset``, ``LSTM.py:8-25``)."""
    n = y.shape[-1]
    padded = torch.cat([y[..., :1].expand(*y.shape[:-1], seq_len - 1), y], -1)
    idx = (torch.arange(n - 1, device=y.device)[:, None]
           + torch.arange(seq_len, device=y.device)[None, :])
    return padded[..., idx], y[..., 1:]


def _lecun_normal_(w, fan_in: int, generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class _Net(nn.Module):
    """The window-as-features LSTM and its two heads."""

    def __init__(self, seq_len: int, hidden_size: int, num_layers: int):
        super().__init__()
        self.lstm = nn.LSTM(seq_len, hidden_size, num_layers,
                            batch_first=True)
        self.dense0 = nn.Linear(hidden_size, 128)
        self.dense1 = nn.Linear(128, 2)
        for name, p in self.lstm.named_parameters():
            if name.startswith("bias_ih"):
                p.requires_grad_(False)  # flax's input kernels have no bias

    @torch.no_grad()
    def init_flax(self, generator=None):
        """flax's initial values, drawn from ``generator``."""
        hidden = self.lstm.hidden_size
        for layer in range(self.lstm.num_layers):
            w_ih = getattr(self.lstm, f"weight_ih_l{layer}")
            w_hh = getattr(self.lstm, f"weight_hh_l{layer}")
            for gate in range(4):  # i, f, g, o: one flax kernel each
                rows = slice(gate * hidden, (gate + 1) * hidden)
                _lecun_normal_(w_ih[rows], w_ih.shape[1], generator)
                nn.init.orthogonal_(w_hh[rows], generator=generator)
            getattr(self.lstm, f"bias_ih_l{layer}").zero_()
            getattr(self.lstm, f"bias_hh_l{layer}").zero_()
        for dense in (self.dense0, self.dense1):
            _lecun_normal_(dense.weight, dense.in_features, generator)
            dense.bias.zero_()
        return self

    def forward(self, x):
        """``x (B, seq_len)`` -> ``(B, 2)``: mean and softplus std."""
        h, _ = self.lstm(x[:, None, :])  # one timestep, zero initial carry
        h = F.relu(h[:, -1, :])
        h = F.relu(self.dense0(h))
        out = self.dense1(h)
        return torch.stack([out[:, 0], F.softplus(out[:, 1])], dim=-1)


@dataclasses.dataclass
class LSTMState:
    """A trained LSTM: the network, the normalisation and the forecast's
    seed window ``(seq_len,)`` (normalised, ending at ``y[-1]``)."""

    net: _Net
    train_mean: torch.Tensor
    train_std: torch.Tensor
    last_window: torch.Tensor
    config: tuple  # (seq_len, hidden_size, num_layers)

    def forecast(self, generator, rollout_len: int, nsample: int = 50,
                 zs=None):
        """Autoregressive sampling (reference ``LSTM.Forecast``,
        ``LSTM.py:99-112``): de-normalised samples ``(nsample,
        rollout_len)``; ``zs`` ``(nsample, rollout_len)`` optionally gives
        the standard normals."""
        with torch.no_grad():
            win = self.last_window.expand(nsample, self.config[0])
            if zs is None:
                zs = torch.randn(nsample, rollout_len, dtype=win.dtype,
                                 device=win.device, generator=generator)
            out = []
            for t in range(rollout_len):
                pred = self.net(win)
                smpl = pred[:, 0] + pred[:, 1] * zs[:, t]
                win = torch.cat([win[:, 1:], smpl[:, None]], dim=-1)
                out.append(smpl)
            return torch.stack(out, dim=-1) * self.train_std + self.train_mean


def _nll_vec(out, targets):
    """Per-window Gaussian NLL terms (the reference sums them over the
    batch, ``LSTM.py:72-74``)."""
    mean, std = out[:, 0], out[:, 1]
    return (0.5 * ((targets - mean) / std) ** 2 + torch.log(std)
            + 0.5 * math.log(2 * math.pi))


def _train(net, y, seq_len: int, epochs: int, batch_size: int, lr: float,
           generator, perms):
    """Adam on the summed NLL of shuffled minibatches; returns ``(mean,
    std, last window, per-epoch mean losses (epochs,))``."""
    # ddof=1: the reference normalises by torch.Tensor.std()
    mean, std = torch.mean(y), torch.std(y)
    windows, targets = make_windows((y - mean) / std, seq_len)
    n = windows.shape[0]
    batch_size = min(batch_size, n)
    # ceil: the reference's DataLoader (drop_last=False) trains on the
    # remainder too; the permutation is padded with -1, masked out
    nbatch = -(-n // batch_size)
    pad = torch.full((nbatch * batch_size - n,), -1, dtype=torch.long,
                     device=y.device)
    opt = Adam([p for p in net.parameters() if p.requires_grad], lr,
               epochs * nbatch)
    losses = []
    for epoch in range(epochs):
        perm = (perms[epoch].to(y.device) if perms is not None else
                torch.randperm(n, generator=generator, device=y.device))
        batch_losses = []
        for bidx in torch.cat([perm, pad]).reshape(nbatch, batch_size):
            mask = (bidx >= 0).to(y.dtype)
            safe = torch.clamp(bidx, min=0)
            opt.zero_grad()
            loss = torch.sum(_nll_vec(net(windows[safe]), targets[safe])
                             * mask)
            loss.backward()
            opt.step()
            batch_losses.append(loss.detach())
        losses.append(torch.mean(torch.stack(batch_losses)))
    # forecast seed: the window shifted to end at the last observation
    # (reference LSTM.py:100-102: cat(xin[1:], xout))
    last_window = torch.cat([windows[-1][1:], targets[-1:]], -1)
    return mean, std, last_window, torch.stack(losses)


def train_lstm(y, seq_len: int = 20, hidden_size: int = 64,
               num_layers: int = 2, epochs: int = 100, batch_size: int = 128,
               lr: float = 0.01, generator=None, init_params=None,
               perms=None, device=None) -> LSTMState:
    """Fit the LSTM baseline on a price or level series ``y`` (float32, on
    ``device``: by default ``y``'s if it is a tensor, else ``"cuda"``).
    ``generator`` (on that device; default seeded 0) draws the initial
    values and one permutation per epoch; ``init_params`` (a flax
    parameter tree, e.g. the JAX package's) and ``perms`` ``(epochs, N-1)``
    replace them."""
    if device is None:
        device = y.device if torch.is_tensor(y) else "cuda"
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    if generator is None:
        generator = torch.Generator(device=y.device).manual_seed(0)
    net = _Net(seq_len, hidden_size, num_layers).to(y.device)
    if init_params is not None:
        from ..convert import lstm_params_from_flax

        net.load_state_dict(lstm_params_from_flax(init_params, y.device))
    else:
        net.init_flax(generator)
    mean, std, last_window, _ = _train(net, y, seq_len, epochs, batch_size,
                                       lr, generator, perms)
    return LSTMState(net=net, train_mean=mean, train_std=std,
                     last_window=last_window,
                     config=(seq_len, hidden_size, num_layers))


class LSTMModel:
    """Reference-style wrapper (``LSTM(...)``, then ``Train`` /
    ``Forecast``)."""

    def __init__(self, train_x, train_y, seq_len: int = 20,
                 hidden_size: int = 64, num_layers: int = 2,
                 batch_size: int = 128, device=None):
        if device is None:
            device = train_y.device if torch.is_tensor(train_y) else "cuda"
        self.train_y = torch.as_tensor(train_y, dtype=torch.float32,
                                       device=device)
        self.seq_len = seq_len
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.batch_size = batch_size
        self.state = None

    def Train(self, epochs: int, display: bool = False, generator=None):
        self.state = train_lstm(self.train_y, self.seq_len, self.hidden_size,
                                self.num_layers, epochs, self.batch_size,
                                generator=generator)
        return self.state

    def Forecast(self, test_x, nsample: int = 50, generator=None):
        if self.state is None:
            raise RuntimeError("call Train first")
        if generator is None:
            generator = torch.Generator(
                device=self.train_y.device).manual_seed(1)
        return self.state.forecast(generator, test_x.shape[-1], nsample)
