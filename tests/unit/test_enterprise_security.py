"""Enterprise security tier (SURVEY §2 row 59 tail):
key lifecycle, encrypt-then-MAC, RBAC sessions, DP budget, secret sharing."""

import numpy as np
import pytest

from spinglass_tpu.utils import enterprise_security as es


class TestKeyLifecycle:
    def test_derive_stable_and_purpose_scoped(self):
        km = es.KeyManager(master_key=b"m" * 32)
        k1, v1 = km.current("checkpoints")
        k2, _ = km.current("checkpoints")
        k3, _ = km.current("results")
        assert k1 == k2 and v1 == 1
        assert k1 != k3

    def test_rotation_keeps_old_versions_decryptable(self):
        km = es.KeyManager()
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        blob = es.encrypt_array(arr, km, purpose="p")
        v2 = km.rotate("p")
        assert v2 == 2
        # old blob still decrypts via its recorded version
        np.testing.assert_array_equal(es.decrypt_array(blob, km), arr)
        # new encryptions use the new version
        blob2 = es.encrypt_array(arr, km, purpose="p")
        assert blob2["key_version"] == 2
        np.testing.assert_array_equal(es.decrypt_array(blob2, km), arr)

    def test_purge_retired(self):
        km = es.KeyManager()
        km.current("p")
        km.rotate("p")
        assert km.purge_retired("p") == 1
        with pytest.raises(KeyError):
            km.by_version("p", 1)


class TestEncryptArray:
    def test_roundtrip_and_tamper_detection(self):
        km = es.KeyManager()
        arr = np.random.default_rng(0).normal(size=(8, 8))
        blob = es.encrypt_array(arr, km)
        np.testing.assert_array_equal(es.decrypt_array(blob, km), arr)
        # ciphertext differs from plaintext bytes
        assert blob["ciphertext"] != arr.tobytes()
        # tampering is detected
        ct = bytearray(blob["ciphertext"])
        ct[0] ^= 0xFF
        blob["ciphertext"] = bytes(ct)
        with pytest.raises(ValueError, match="integrity"):
            es.decrypt_array(blob, km)

    def test_keystream_not_repeating_xor(self):
        """The reference repeated the key (advanced_security_framework.py:
        85-90); a PRF counter keystream must not repeat with period 32."""
        ks = es._keystream(b"k" * 32, b"n" * 16, 128)
        assert ks[:32] != ks[32:64]


class TestRBAC:
    def test_default_roles_and_wildcards(self):
        rbac = es.RBAC()
        rbac.assign("alice", "researcher")
        rbac.assign("bob", "viewer")
        assert rbac.has_permission("alice", "problems/tsp1", "solve")
        assert not rbac.has_permission("bob", "problems/tsp1", "solve")
        assert rbac.has_permission("bob", "results/run9", "read")
        rbac.revoke("alice", "researcher")
        assert not rbac.has_permission("alice", "problems/tsp1", "solve")

    def test_session_expiry_and_scope(self):
        rbac = es.RBAC()
        rbac.assign("op", "operator")
        tok = rbac.create_session("op", duration_seconds=3600,
                                  scope=["metrics/*"])
        # scoped session: metrics ok, problems denied even though the ROLE
        # would allow it
        assert rbac.has_permission("op", "metrics/latency", "read", tok)
        assert not rbac.has_permission("op", "problems/x", "read", tok)
        # expired session
        tok2 = rbac.create_session("op", duration_seconds=-1)
        assert rbac.validate_session(tok2) is None
        assert not rbac.has_permission("op", "metrics/x", "read", tok2)

    def test_unknown_role_rejected(self):
        rbac = es.RBAC()
        with pytest.raises(KeyError):
            rbac.assign("x", "superuser")


class TestDifferentialPrivacy:
    def test_budget_accounting_and_exhaustion(self):
        dp = es.DifferentialPrivacy(epsilon=1.0, seed=0)
        x = np.zeros(1000)
        dp.laplace(x, eps=0.4)
        dp.gaussian(x, eps=0.4)
        assert dp.remaining_budget() == pytest.approx(0.2)
        with pytest.raises(RuntimeError, match="budget"):
            dp.laplace(x, eps=0.3)

    def test_noise_scales_with_epsilon(self):
        lo = es.DifferentialPrivacy(epsilon=100.0, seed=1)
        hi = es.DifferentialPrivacy(epsilon=100.0, seed=1)
        x = np.zeros(20000)
        noisy_tight = lo.laplace(x, sensitivity=1.0, eps=10.0)
        noisy_loose = hi.laplace(x, sensitivity=1.0, eps=0.1)
        assert noisy_loose.std() > 10 * noisy_tight.std()

    def test_private_mean(self):
        dp = es.DifferentialPrivacy(epsilon=5.0, seed=2)
        parties = [np.full(500, v, float) for v in (1.0, 2.0, 3.0)]
        agg = dp.private_mean(parties, sensitivity=1.0, eps=2.0)
        assert abs(agg.mean() - 2.0) < 0.1


class TestSecretSharing:
    def test_exact_reconstruction(self):
        ss = es.SecretSharing(n_parties=4, seed=3)
        secret = np.random.default_rng(0).normal(size=(5, 7))
        shares = ss.share(secret)
        assert len(shares) == 4
        np.testing.assert_allclose(ss.reconstruct(shares), secret,
                                   atol=1e-5)

    def test_single_share_is_uninformative(self):
        ss = es.SecretSharing(n_parties=3, seed=4)
        a = ss.share(np.zeros(100))
        b = ss.share(np.ones(100) * 123.456)
        # first shares of wildly different secrets are identically
        # distributed uniform noise — compare gross statistics
        assert abs(float(np.mean(a[0])) - float(np.mean(b[0]))) < 0.3 * float(
            np.std(a[0]))

    def test_secure_sum(self):
        ss = es.SecretSharing(n_parties=3, seed=5)
        inputs = [np.array([1.5, -2.0]), np.array([0.5, 4.0]),
                  np.array([2.0, 1.0])]
        np.testing.assert_allclose(ss.secure_sum(inputs),
                                   np.array([4.0, 3.0]), atol=1e-5)


def test_security_report():
    rbac = es.RBAC()
    rbac.assign("u", "viewer")
    rbac.has_permission("u", "problems/x", "write")  # denied
    km = es.KeyManager()
    km.current("p")
    rep = es.security_report(rbac, km)
    assert rep["n_users"] == 1
    assert rep["n_denied"] >= 1
    assert rep["key_purposes"] == {"p": 1}
