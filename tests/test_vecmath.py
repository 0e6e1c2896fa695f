"""Unit tests for core vector math vs the oracle formulas (vec3.go:212-221)."""

import numpy as np
import jax.numpy as jnp

from raytracer_tpu.core import vecmath as vm
import oracle


def test_dot_cross_norm(rng):
    a = rng.normal(size=(32, 3)).astype(np.float32)
    b = rng.normal(size=(32, 3)).astype(np.float32)
    np.testing.assert_allclose(vm.dot(a, b), np.sum(a * b, -1), rtol=1e-6)
    np.testing.assert_allclose(vm.cross(a, b), np.cross(a, b), rtol=1e-5, atol=1e-6)
    n = vm.normalize(a)
    np.testing.assert_allclose(vm.length(n), np.ones(32), rtol=1e-6)


def test_reflect_matches_oracle(rng):
    for _ in range(20):
        v = rng.normal(size=3).astype(np.float32)
        n = rng.normal(size=3).astype(np.float32)
        n = n / np.linalg.norm(n)
        got = np.asarray(vm.reflect(jnp.asarray(v), jnp.asarray(n)))
        want = oracle.reflect(v, n)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_reflect_preserves_length(rng):
    v = rng.normal(size=(64, 3)).astype(np.float32)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n = n / np.linalg.norm(n, axis=-1, keepdims=True)
    r = vm.reflect(jnp.asarray(v), jnp.asarray(n))
    np.testing.assert_allclose(vm.length(r), np.linalg.norm(v, axis=-1), rtol=1e-5)


def test_refract_matches_oracle_and_snell(rng):
    for _ in range(20):
        uv = rng.normal(size=3).astype(np.float32)
        uv = uv / np.linalg.norm(uv)
        n = -uv + 0.3 * rng.normal(size=3).astype(np.float32)
        n = n / np.linalg.norm(n)
        if uv @ n > 0:
            n = -n
        eta = 1.0 / 1.5
        got = np.asarray(
            vm.refract(jnp.asarray(uv), jnp.asarray(n), jnp.float32(eta))
        )
        want = oracle.refract(uv, n, eta)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        # Snell: sin(theta_t) = eta * sin(theta_i)
        sin_i = np.linalg.norm(np.cross(uv, n))
        sin_t = np.linalg.norm(np.cross(got / np.linalg.norm(got), n))
        np.testing.assert_allclose(sin_t, eta * sin_i, rtol=1e-3, atol=1e-5)


def test_schlick_matches_oracle():
    for cos_t in (0.0, 0.2, 0.7, 1.0):
        for eta in (1.5, 1 / 1.5):
            got = float(vm.schlick_reflectance(jnp.float32(cos_t), jnp.float32(eta)))
            want = oracle.schlick(cos_t, eta)
            np.testing.assert_allclose(got, want, rtol=1e-5)
    # Normal incidence: r0 = ((1-eta)/(1+eta))^2.
    np.testing.assert_allclose(
        float(vm.schlick_reflectance(jnp.float32(1.0), jnp.float32(1.5))),
        ((1 - 1.5) / (1 + 1.5)) ** 2,
        rtol=1e-6,
    )


def test_near_zero():
    assert bool(vm.near_zero(jnp.array([1e-9, -1e-9, 0.0])))
    assert not bool(vm.near_zero(jnp.array([1e-9, 1e-7, 0.0])))
