"""Random-draw providers: the port's RNG seam.

JAX threefry streams and torch Philox streams never agree bit for bit, so
every move of the port takes a :class:`Draws` object instead of a generator.
Its tree mirrors ``jax.random``: a move calls ``split``/``fold_in`` and the
draw methods at exactly the points where the ``bnpc_tpu`` counterpart splits
its key and draws. A provider that wraps a JAX key and hands back the JAX
package's own draws (the parity tests have one) therefore replays any port
function against its JAX counterpart on the same key.

:class:`TorchDraws` is the runtime provider: one ``torch.Generator`` on the
sampler's device. It flattens the key tree: ``split`` and ``fold_in`` hand
back providers over the same stream, so every draw is fresh and independent
(correct in distribution; the tree position only matters for replay).
``fold_axis`` is the one exception: it hands back a provider over a second
generator of its own, seeded from (seed, shard index), so a mutation shard's
per-mutation draws never touch the stream that every shard must replay
alike (bnpc_tpu's ``fold_in(key, axis_index)``, parallel/axis.py).

Conventions shared by every provider:
  * floats are float32, indices int32 (``randint``, ``categorical``,
    ``permutation``);
  * ``bits`` returns uint32 values held in an int64 tensor (torch has no
    general-purpose uint32 arithmetic);
  * ``categorical(logits)`` reduces the last axis (jax.random.categorical).
"""

from __future__ import annotations

import numpy as np
import torch


def gumbel_of(u: torch.Tensor) -> torch.Tensor:
    """jax.random.gumbel's transform of uniforms `u`: -log(-log(U)), U
    clamped to [tiny, 1)."""
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32)
                                         .tiny)))


def axis_seed(seed: int, i: int) -> int:
    """Seed of shard `i`'s own stream beside the stream seeded `seed`."""
    return int(np.random.SeedSequence([int(seed), int(i)])
               .generate_state(1, np.uint64)[0] >> 1)


class Draws:
    """Interface of a draw provider (see the module docstring)."""

    device: torch.device

    def split(self, n: int) -> list["Draws"]:
        raise NotImplementedError

    def fold_in(self, i: int) -> "Draws":
        raise NotImplementedError

    def fold_axis(self, i: int) -> "Draws":
        """The draws of mutation shard `i` (MutAxis.fold_key): bnpc_tpu's
        ``fold_in(key, axis_index)``."""
        raise NotImplementedError

    def uniform(self, shape) -> torch.Tensor:
        raise NotImplementedError

    def normal(self, shape) -> torch.Tensor:
        raise NotImplementedError

    def gumbel(self, shape) -> torch.Tensor:
        raise NotImplementedError

    def bits(self, shape) -> torch.Tensor:
        raise NotImplementedError

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        raise NotImplementedError

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def permutation(self, n: int) -> torch.Tensor:
        raise NotImplementedError

    def beta(self, a, b) -> torch.Tensor:
        raise NotImplementedError

    def gamma(self, a) -> torch.Tensor:
        raise NotImplementedError

    def beta_binary(self, p: float, q: float, xm, xm0) -> torch.Tensor:
        """Exact Beta(p + xm, q + xm0) field for binary planes."""
        raise NotImplementedError

    def fresh_rows(self, p: float, q: float, xm, xm0) -> torch.Tensor:
        """[n, m] newborn row of every cell, clipped to [TMIN, TMAX]: row c
        is ``fold_in(c).beta_binary(p, q, xm[c], xm0[c])`` (bnpc_tpu's
        counter-keyed rows, models/gibbs.py::_hoisted_randomness)."""
        raise NotImplementedError

    def beta_general(self, a, b) -> torch.Tensor:
        """Exact Beta(a, b) for array-valued parameters."""
        raise NotImplementedError

    def truncnorm(self, a, b, loc, scale) -> torch.Tensor:
        """Truncated normal on [loc + a*scale, loc + b*scale]."""
        raise NotImplementedError


class TorchDraws(Draws):
    """Runtime provider: one torch.Generator on `device`, seeded once.

    Numbers are generated on the generator's own device and returned on
    ``self.device`` (the same device here; a subclass may generate on the
    CPU for a device-independent stream)."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(self.seed)
        self._axis: dict[int, TorchDraws] = {}

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device)

    def full(self, x) -> torch.Tensor:
        """`x` as a float32 tensor on self.device; a Python number goes by
        a fill kernel, not a blocking host-to-device copy."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.full((), float(x), dtype=torch.float32,
                          device=self.device)

    def split(self, n: int) -> list["Draws"]:
        return [self] * n

    def fold_in(self, i: int) -> "Draws":
        return self

    def fold_axis(self, i: int) -> "TorchDraws":
        # Made once per provider (a chain's), of the provider's own class.
        d = self._axis.get(i)
        if d is None:
            d = self._axis[i] = type(self)(axis_seed(self.seed, i),
                                           self.device)
        return d

    def uniform(self, shape) -> torch.Tensor:
        return self._out(torch.rand(shape, generator=self.gen,
                                    device=self.gen.device,
                                    dtype=torch.float32))

    def normal(self, shape) -> torch.Tensor:
        return self._out(torch.randn(shape, generator=self.gen,
                                     device=self.gen.device,
                                     dtype=torch.float32))

    def gumbel(self, shape) -> torch.Tensor:
        return gumbel_of(self.uniform(shape))

    def bits(self, shape) -> torch.Tensor:
        return self._out(torch.randint(0, 2**32, shape, generator=self.gen,
                                       device=self.gen.device,
                                       dtype=torch.int64))

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        return self._out(torch.randint(lo, hi, shape, generator=self.gen,
                                       device=self.gen.device,
                                       dtype=torch.int64).to(torch.int32))

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        z = logits + self.gumbel(tuple(logits.shape))
        return torch.argmax(z, dim=-1).to(torch.int32)

    def permutation(self, n: int) -> torch.Tensor:
        return self._out(torch.randperm(n, generator=self.gen,
                                        device=self.gen.device)
                         .to(torch.int32))

    def gamma(self, a) -> torch.Tensor:
        a = torch.as_tensor(a, dtype=torch.float32).to(self.gen.device)
        return self._out(torch._standard_gamma(a, generator=self.gen))

    def beta(self, a, b) -> torch.Tensor:
        a, b = torch.broadcast_tensors(self.full(a), self.full(b))
        ga, gb = self.gamma(a), self.gamma(b)
        return ga / (ga + gb)

    def beta_binary(self, p: float, q: float, xm, xm0) -> torch.Tensor:
        from bnpc_tpu_torch.ops.randomx import beta_binary

        return beta_binary(self, p, q, xm, xm0)

    def fresh_rows(self, p: float, q: float, xm, xm0) -> torch.Tensor:
        # fold_in(c) is this same stream, so one batched draw over the whole
        # planes has the law of n per-cell draws.
        from bnpc_tpu_torch.config import TMAX, TMIN

        return torch.clamp(self.beta_binary(p, q, xm, xm0), TMIN,
                           TMAX).to(torch.float32)

    def beta_general(self, a, b) -> torch.Tensor:
        from bnpc_tpu_torch.ops.randomx import beta_general

        return beta_general(self, a, b)

    def truncnorm(self, a, b, loc, scale) -> torch.Tensor:
        from bnpc_tpu_torch.ops.truncnorm import rvs

        return rvs(self, a, b, loc, scale)


class StackedDraws(Draws):
    """The draws of a batch of chains: chain c's own provider at slot c.

    Every draw returns a ``[C, ...]`` tensor whose slice c is exactly what
    chain c's provider returns for the same call, so chain c of a batched
    move consumes what its one-chain run consumes. Shapes are FULL shapes,
    chain axis first (``uniform((C, k, m))`` draws ``uniform((k, m))`` from
    each chain); tensor parameters (``gamma(a)``, ``categorical(logits)``,
    ...) carry the chain axis too. ``split``, ``fold_in`` and
    ``fold_axis`` act on every chain's provider.

    Each primitive draw is one call per chain and one stack. Where every
    provider is a :class:`TorchDraws` that computes a composite (Beta,
    truncated normal, categorical) from primitive draws, and the draws are
    on a CUDA device, the composite runs once on the stacked primitives (a
    CUDA elementwise kernel rounds every element alike, wherever it sits in
    its tensor). Any other provider (the tests' JaxDraws) computes its
    composites per chain, and so does a CPU batch: a CPU elementwise kernel
    takes a vector body and a scalar tail that can round a transcendental
    an ulp apart, and the samplers' tails amplify that, so only the
    one-chain shapes give the one-chain bits there."""

    def __init__(self, providers):
        self.chains = list(providers)
        self.device = self.chains[0].device

    def __len__(self) -> int:
        return len(self.chains)

    def take(self, idx) -> "StackedDraws":
        """The sub-batch of the chains at host indices `idx`."""
        return StackedDraws([self.chains[i] for i in idx])

    def split(self, n: int) -> list["Draws"]:
        parts = [d.split(n) for d in self.chains]
        return [StackedDraws([p[i] for p in parts]) for i in range(n)]

    def fold_in(self, i: int) -> "Draws":
        return StackedDraws([d.fold_in(i) for d in self.chains])

    def fold_axis(self, i: int) -> "Draws":
        return StackedDraws([d.fold_axis(i) for d in self.chains])

    def _batched(self, name: str) -> bool:
        """True when composite `name` runs once on stacked primitives (the
        class docstring): TorchDraws' own composite on every chain, on
        CUDA."""
        return self.device.type == "cuda" and all(
            isinstance(p, TorchDraws)
            and getattr(type(p), name) is getattr(TorchDraws, name)
            for p in self.chains)

    def _each(self, draw, shape, *args) -> torch.Tensor:
        shape = tuple(shape)
        if not shape or shape[0] != len(self.chains):
            raise ValueError(f"shape {shape} must lead with the "
                             f"{len(self.chains)} chains")
        return torch.stack([getattr(d, draw)(shape[1:], *args)
                            for d in self.chains])

    def _per_chain(self, draw, *args) -> torch.Tensor:
        """Chain c's `draw` on slice c of every tensor argument that has a
        chain axis; numbers and 0-d tensors go to every chain as given."""
        def at(x, c):
            return x[c] if isinstance(x, torch.Tensor) and x.dim() else x

        return torch.stack([getattr(d, draw)(*(at(x, c) for x in args))
                            for c, d in enumerate(self.chains)])

    def full(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.full((), float(x), dtype=torch.float32,
                          device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return self._each("uniform", shape)

    def normal(self, shape) -> torch.Tensor:
        return self._each("normal", shape)

    def gumbel(self, shape) -> torch.Tensor:
        if self._batched("gumbel"):
            return TorchDraws.gumbel(self, shape)
        return self._each("gumbel", shape)

    def bits(self, shape) -> torch.Tensor:
        return self._each("bits", shape)

    def randint(self, shape, lo: int, hi: int) -> torch.Tensor:
        return self._each("randint", shape, lo, hi)

    def categorical(self, logits: torch.Tensor) -> torch.Tensor:
        if self._batched("categorical"):
            return TorchDraws.categorical(self, logits)
        return self._per_chain("categorical", logits)

    def permutation(self, n: int) -> torch.Tensor:
        return torch.stack([d.permutation(n) for d in self.chains])

    def gamma(self, a) -> torch.Tensor:
        return self._per_chain("gamma", a)

    def beta(self, a, b) -> torch.Tensor:
        if self._batched("beta"):
            return TorchDraws.beta(self, a, b)
        return self._per_chain("beta", a, b)

    def beta_binary(self, p: float, q: float, xm, xm0) -> torch.Tensor:
        """`xm`, `xm0` carry the chain axis: chain c's planes are
        xm[c], xm0[c]."""
        if self._batched("beta_binary"):
            return TorchDraws.beta_binary(self, p, q, xm, xm0)
        return torch.stack([d.beta_binary(p, q, xm[c], xm0[c])
                            for c, d in enumerate(self.chains)])

    def fresh_rows(self, p: float, q: float, xm, xm0) -> torch.Tensor:
        return torch.stack([d.fresh_rows(p, q, xm, xm0)
                            for d in self.chains])

    def beta_general(self, a, b) -> torch.Tensor:
        if self._batched("beta_general"):
            return TorchDraws.beta_general(self, a, b)
        return self._per_chain("beta_general", a, b)

    def truncnorm(self, a, b, loc, scale) -> torch.Tensor:
        a, b, loc, scale = torch.broadcast_tensors(a, b, loc, scale)
        if self._batched("truncnorm"):
            return TorchDraws.truncnorm(self, a, b, loc, scale)
        return self._per_chain("truncnorm", a, b, loc, scale)


def replays(draws: Draws, name: str) -> bool:
    """True where a kernel that takes the primitives of composite `name`
    replays what `draws` would draw: a TorchDraws that keeps TorchDraws'
    own `name`, or a StackedDraws that runs it once on stacked primitives
    (``StackedDraws._batched``)."""
    if isinstance(draws, StackedDraws):
        return draws._batched(name)
    return (isinstance(draws, TorchDraws)
            and getattr(type(draws), name) is getattr(TorchDraws, name))
