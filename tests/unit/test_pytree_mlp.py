"""The pytree dataclass helper (core/pytree.py) and the plain-JAX MLP
(rl/mlp.py) that replaced flax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.core import pytree
from spinglass_tpu.rl.mlp import MLP


@pytree.dataclass
class _State:
    x: jax.Array
    y: jax.Array
    n: int = pytree.static_field(default=3)


class TestPytreeDataclass:
    def test_leaves_exclude_static_fields(self):
        s = _State(x=jnp.ones(2), y=jnp.zeros(3), n=5)
        leaves, treedef = jax.tree_util.tree_flatten(s)
        assert len(leaves) == 2
        back = jax.tree_util.tree_unflatten(treedef, leaves)
        assert back.n == 5 and back.x.shape == (2,)

    def test_replace_and_frozen(self):
        s = _State(x=jnp.ones(2), y=jnp.zeros(3))
        t = s.replace(y=jnp.ones(3))
        assert float(t.y.sum()) == 3.0 and float(s.y.sum()) == 0.0
        with pytest.raises(Exception):
            s.x = jnp.zeros(2)

    def test_static_field_is_static_under_jit(self):
        traces = []

        @jax.jit
        def f(s):
            traces.append(s.n)              # a Python int while tracing
            return s.x * s.n

        out = f(_State(x=jnp.ones(2), y=jnp.zeros(1), n=4))
        np.testing.assert_array_equal(np.asarray(out), [4.0, 4.0])
        f(_State(x=jnp.ones(2), y=jnp.zeros(1), n=7))
        assert traces == [4, 7]             # a new static value retraces

    def test_problem_pytrees_roundtrip(self):
        from spinglass_tpu.core.problem import IsingProblem

        p = IsingProblem.from_dense(np.ones((4, 4)))
        q = jax.tree.map(lambda a: a * 2, p)
        assert q.n_spins == 4
        np.testing.assert_allclose(np.asarray(q.h), 0.0)
        assert float(q.j[0, 1]) == 2.0


class TestMLP:
    def test_shapes_and_param_tree(self):
        mlp = MLP((16, 8), 3)
        x = jnp.ones((5, 7))
        params = mlp.init(jax.random.key(0), x)
        assert [l["w"].shape for l in params["hidden"]] == [(7, 16), (16, 8)]
        assert params["out"]["w"].shape == (8, 3)
        assert mlp.apply(params, x).shape == (5, 3)
        assert mlp.apply(params, jnp.ones((2, 4, 7))).shape == (2, 4, 3)

    def test_init_scale_and_determinism(self):
        mlp = MLP((256,), 1)
        a = mlp.init(jax.random.key(1), jnp.ones((1, 400)))
        b = mlp.init(jax.random.key(1), jnp.ones((1, 400)))
        w = np.asarray(a["hidden"][0]["w"])
        np.testing.assert_array_equal(w, np.asarray(b["hidden"][0]["w"]))
        assert abs(w.std() - 1.0 / np.sqrt(400)) < 0.1 / np.sqrt(400)
        assert np.abs(w).max() <= 2.0 / np.sqrt(400) / 0.8796 + 1e-6
        np.testing.assert_array_equal(np.asarray(a["hidden"][0]["b"]), 0.0)

    def test_layer_norm_normalizes(self):
        mlp = MLP((32,), 2, activation=lambda v: v, layer_norm=True)
        x = jax.random.normal(jax.random.key(2), (6, 5)) * 10 + 3
        params = mlp.init(jax.random.key(3), x)
        layer = params["hidden"][0]
        z = x @ layer["w"] + layer["b"]
        z = (z - z.mean(-1, keepdims=True)) / jnp.sqrt(
            z.var(-1, keepdims=True) + 1e-6)
        want = z @ params["out"]["w"] + params["out"]["b"]
        np.testing.assert_allclose(np.asarray(mlp.apply(params, x)),
                                   np.asarray(want), rtol=1e-4, atol=1e-5)

    def test_gradients_flow(self):
        mlp = MLP((8,), 1)
        x = jnp.ones((3, 4))
        params = mlp.init(jax.random.key(4), x)
        g = jax.grad(lambda p: jnp.sum(mlp.apply(p, x) ** 2))(params)
        assert all(np.all(np.isfinite(np.asarray(l)))
                   for l in jax.tree.leaves(g))
        assert float(jnp.abs(g["out"]["w"]).sum()) > 0

    @pytest.mark.parametrize("mode,n_means", [("discrete", 0),
                                              ("continuous", 2),
                                              ("hybrid", 1)])
    def test_actor_critic_heads(self, mode, n_means):
        from spinglass_tpu.rl.ppo import ActorCritic

        model = ActorCritic(action_mode=mode, hidden_sizes=(16,))
        obs = jnp.ones((3, 16))
        params = model.init(jax.random.key(0), obs)
        assert ("log_std" in params) == (n_means > 0)
        dist, value = model.apply(params, obs)
        assert value.shape == (3,)
        if mode != "continuous":
            assert dist["logits"].shape == (3, model.n_actions)
        if n_means:
            np.testing.assert_allclose(np.asarray(dist["log_std"]), -0.7)

    def test_qnetwork_uses_layer_norm(self):
        from spinglass_tpu.rl.dqn import QNetwork

        q = QNetwork(n_actions=5, hidden_sizes=(8,))
        params = q.init(jax.random.key(0), jnp.ones((2, 16)))
        assert set(params["hidden"][0]) == {"w", "b", "scale", "offset"}
        assert q.apply(params, jnp.ones((2, 16))).shape == (2, 5)
