"""Experimental: Poisson jump model with a time-varying population gain.

Counterpart of ``poor_man_gplvm_tpu/experimental/gain.py`` (reference
poor_man_gplvm/experimental/): rate(t, n) = g_t * lambda(x_t, n).  The
gain M-step is the per-time MLE ``g_t = total spikes_t / total expected
rate_t`` (reference fit_tuning_helper_exp.py:79-103), one (T, L) @ (L,)
product.  The gain enters the emissions exactly like a per-bin dt
(``lambda*g*dt + 1e-20``, reference decoder_exp.py:86-99), so the decode
runs the smoother's per-bin dt path (``hmm.smooth_combined_chunked(dt_l=
gain)``) on the model's engine: K1/K2, or K3/K4 for long sequences, on the
card.

As in the JAX package, tuning is threaded explicitly through the M-step
(the reference mutates ``self.tuning`` there).  Random draws take a CPU
``torch.Generator`` in place of ``key``.  There is no progress bar (the
card's machine has no tqdm).
"""

from __future__ import annotations

import numpy as np
import torch

from poor_man_gplvm_tpu_torch.models.base import check_no_mesh, _seeded
from poor_man_gplvm_tpu_torch.models.jump1d import PoissonGPLVMJump1D
from poor_man_gplvm_tpu_torch.ops import emissions, hmm
from poor_man_gplvm_tpu_torch.ops import kernels as gpk
from poor_man_gplvm_tpu_torch.ops import mstep as fth
from poor_man_gplvm_tpu_torch.utils import compat

__all__ = [
    "PoissonGPLVMGain1D_gain",
    "get_statistics_gain",
    "get_gain_mstep",
    "get_gain_mstep_chunk",
    "poisson_m_step_objective_gain",
    "shuffle_and_decode_gain",
]


def get_statistics_gain(log_posterior_probs, y, gain):
    """Posterior-weighted observation/time/gain per latent bin
    (reference fit_tuning_helper_exp.py:61-76)."""
    log_posterior_probs = torch.as_tensor(log_posterior_probs,
                                          dtype=torch.float32)
    dev = log_posterior_probs.device
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    gain = torch.as_tensor(gain, dtype=torch.float32, device=dev)
    posterior_probs = torch.exp(log_posterior_probs)
    y_weighted = posterior_probs.T @ y
    t_weighted = posterior_probs.sum(dim=0)
    gain_weighted = (posterior_probs.T @ gain) / (t_weighted + 1e-20)
    return y_weighted, t_weighted, gain_weighted


def get_gain_mstep(y, log_posterior, tuning):
    """Per-time gain MLE: total spikes / total expected rate
    (reference fit_tuning_helper_exp.py:79-103); one matvec, total
    expected rate_t = post_t . rowsum(tuning)."""
    log_posterior = torch.as_tensor(log_posterior, dtype=torch.float32)
    dev = log_posterior.device
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    tuning = torch.as_tensor(tuning, dtype=torch.float32, device=dev)
    total_expected = torch.exp(log_posterior) @ tuning.sum(dim=1)
    return y.sum(dim=1) / (total_expected + 1e-20)


def get_gain_mstep_chunk(y, log_posterior, tuning, n_time_per_chunk=10000):
    """Chunked gain M-step (reference fit_tuning_helper_exp.py:105-122)."""
    n_chunks = -(-y.shape[0] // n_time_per_chunk)
    parts = []
    for n in range(n_chunks):
        sl = slice(n * n_time_per_chunk, (n + 1) * n_time_per_chunk)
        parts.append(get_gain_mstep(y[sl], log_posterior[sl], tuning))
    return torch.cat(parts, dim=0)


def poisson_m_step_objective_gain(
    weight, hyperparam, basis_mat, y_weighted, t_weighted, gain_weighted
):
    """Gain-aware Poisson objective: rates scaled by the posterior-weighted
    gain per latent bin (reference fit_tuning_helper_exp.py:144-164)."""
    tuning_base = fth.get_tuning_softplus(weight, basis_mat)
    pf_hat = tuning_base * gain_weighted[:, None]
    norm_term = pf_hat * t_weighted[:, None]
    fit_term = torch.xlogy(y_weighted, pf_hat + 1e-20)
    log_likelihood = torch.sum(fit_term - norm_term)
    log_prior = fth._norm_logpdf(weight,
                                 hyperparam["param_prior_std"]).sum()
    return -log_likelihood - log_prior


class PoissonGPLVMGain1D_gain(PoissonGPLVMJump1D):
    """Poisson jump model + per-timestep population gain
    (reference experimental/core_exp.py:28-293)."""

    def initialize_params(self, generator):
        out = super().initialize_params(generator)
        self.gain = None
        return out

    def _resolve_gain(self, gain, T):
        if gain is not None:
            return self._as_device(gain)
        if self.gain is not None and len(self.gain) == T:
            return self.gain
        return torch.ones(T, device=self.device)

    def get_gain(self, y, log_posterior_curr, tuning=None):
        tuning = self.tuning if tuning is None else tuning
        return get_gain_mstep(self._as_device(y), log_posterior_curr, tuning)

    def get_gain_chunk(self, y, log_posterior_curr, n_time_per_chunk=10000,
                       tuning=None):
        tuning = self.tuning if tuning is None else tuning
        return get_gain_mstep_chunk(self._as_device(y), log_posterior_curr,
                                    tuning, n_time_per_chunk)

    # ------------------------------------------------------------------
    def sample_y(self, latent_l, hyperparam=None, tuning=None, dt=1.0,
                 gain=None, generator=None):
        """Poisson counts (T, N) at the gain-scaled rates of the path."""
        g = _seeded(generator, 10)
        if tuning is None:
            tuning = self.tuning
        latent_l = torch.as_tensor(latent_l, device=tuning.device)
        gain = self._resolve_gain(gain, len(latent_l))
        rate = tuning[latent_l] * gain[:, None] * dt
        return torch.poisson(rate.cpu(), generator=g).to(self.device)

    def sample(self, T, hyperparam=None, generator=None, init_dynamics=None,
               init_latent=None, dt=1.0, tuning=None, gain=None):
        """Sample a latent path and gain-scaled observations; returns
        (latent_l, y_l)."""
        hyperparam = {} if hyperparam is None else hyperparam
        g = _seeded(generator, 0)
        latent_l = self.sample_latent(
            T, g,
            hyperparam.get("movement_variance", self.movement_variance),
            hyperparam.get("p_move_to_jump", self.p_move_to_jump),
            hyperparam.get("p_jump_to_move", self.p_jump_to_move),
            init_dynamics, init_latent,
        )
        y_l = self.sample_y(latent_l[:, 1], hyperparam, tuning, dt, gain, g)
        return latent_l, y_l

    # ------------------------------------------------------------------
    def _decode_latent(
        self, y, tuning, hyperparam, log_latent_transition_kernel_l,
        log_dynamics_transition_kernel, ma_neuron, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, gain=None, mesh=None,
    ):
        """Gain-aware decode: the gain folded into the per-bin dt of the
        emissions (reference experimental/decoder_exp.py), on the model's
        engine.  ``mesh`` is not ported."""
        check_no_mesh(mesh)
        y = self._as_device(y)
        gain = self._resolve_gain(gain, len(y))
        log_lat = self._as_device(log_latent_transition_kernel_l)
        log_dyn = self._as_device(log_dynamics_transition_kernel)
        trans = hmm.JointTransition(
            Tdyn=torch.exp(log_dyn), Tlat=torch.exp(log_lat),
            logTdyn=log_dyn, logTlat=log_lat)
        return hmm.smooth_combined_chunked(
            y, tuning, hyperparam, trans, ma_neuron, ma_latent,
            likelihood_scale=likelihood_scale,
            n_time_per_chunk=n_time_per_chunk,
            observation_model=self.observation_model,
            engine=self.inference_engine, dt_l=gain,
        )

    def get_gain_mstep_chunk(self, y, log_posterior=None, tuning=None,
                             n_time_per_chunk=10000):
        """Instance wrapper over the chunked gain MLE
        (reference experimental/test_exp.py:13 call signature)."""
        if log_posterior is None:
            log_posterior = self.log_posterior
        if tuning is None:
            tuning = self.tuning
        return get_gain_mstep_chunk(self._as_device(y), log_posterior, tuning,
                                    n_time_per_chunk=n_time_per_chunk)

    def decode_latent_naive_bayes(
        self, y, tuning=None, hyperparam=None, ma_neuron=None, ma_latent=None,
        likelihood_scale=1.0, n_time_per_chunk=10000, dt_l=1.0, gain=None,
        gain_refit_n_iter=1, t_l=None,
    ):
        """Naive-Bayes decode with iterative gain refitting (reference
        core_exp.py:95-126); TsdFrame input or ``t_l`` give a time-indexed
        ``posterior_latent``, as in the JAX package."""
        hyperparam = {} if hyperparam is None else hyperparam
        if compat.is_tsdframe(y):
            t_l = y.t
            y = y.d
        if tuning is None:
            tuning = self.tuning
        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default
        y = self._as_device(y)
        gain = self._resolve_gain(gain, len(y))
        dt_eff = torch.broadcast_to(self._as_device(dt_l), (y.shape[0],))
        for _ in range(gain_refit_n_iter):
            log_post, _, _, _ = emissions.get_naive_bayes_ma_chunk(
                y, tuning, hyperparam, ma_neuron, ma_latent,
                dt_l=gain * dt_eff, n_time_per_chunk=n_time_per_chunk,
                observation_model="poisson",
            )
            gain = self.get_gain_chunk(
                y, log_post, n_time_per_chunk=n_time_per_chunk, tuning=tuning)
        log_post, log_marginal_l, log_marginal_total, ll_per_pos_l = (
            emissions.get_naive_bayes_ma_chunk(
                y, tuning, hyperparam, ma_neuron, ma_latent,
                dt_l=gain * dt_eff, n_time_per_chunk=n_time_per_chunk,
                observation_model="poisson",
            )
        )
        res = {
            "log_posterior": log_post,
            "log_marginal_l": log_marginal_l,
            "log_marginal": float(log_marginal_total),
            "ll_per_pos_l": ll_per_pos_l,
            "gain": gain,
        }
        if t_l is not None:
            res["posterior_latent"] = compat.tsdframe(
                d=torch.exp(log_post), t=t_l)
        return res

    # ------------------------------------------------------------------
    def m_step(self, param_curr, y, log_posterior_curr, tuning_basis,
               hyperparam, opt_state_curr=None, gain_curr=None,
               host_trim=True):
        """Joint M-step: Adam on gain-weighted tuning statistics, then the
        per-time gain MLE under the new tuning (reference
        core_exp.py:128-170)."""
        gain_curr = self._resolve_gain(gain_curr, len(y))
        y_weighted, t_weighted, gain_weighted = get_statistics_gain(
            log_posterior_curr, y, gain_curr)
        adam_res = self.adam_runner(
            param_curr, opt_state_curr, hyperparam, tuning_basis, y_weighted,
            t_weighted, gain_weighted,
        )
        tuning = self.get_tuning(adam_res["params"], hyperparam, tuning_basis)
        if len(y) > 50000:
            gain_new = get_gain_mstep_chunk(y, log_posterior_curr, tuning)
        else:
            gain_new = get_gain_mstep(y, log_posterior_curr, tuning)
        return fth.package_adam_result(
            adam_res, host_trim=host_trim,
            extra={"tuning": tuning, "gain": gain_new})

    def fit_em(
        self, y, hyperparam=None, generator=None, n_iter=20,
        log_posterior_init=None, ma_neuron=None, ma_latent=None,
        n_time_per_chunk=10000, dt=1.0, likelihood_scale=1.0,
        save_every=None, gain_init=None, m_step_step_size=0.01,
        m_step_maxiter=1000, m_step_tol=1e-6, verboase=True, mesh=None,
        **kwargs,
    ):
        """EM alternating tuning/gain M-steps with gain-aware E-steps
        (reference core_exp.py:172-293).  ``generator`` (a CPU
        ``torch.Generator``) draws the initial posterior in place of
        ``key``; ``mesh`` is not ported; with ``verboase`` each iteration
        prints a line (no progress bar)."""
        check_no_mesh(mesh)
        verboase = kwargs.pop("verbose", verboase)
        if kwargs:
            raise TypeError(f"unexpected keyword arguments {sorted(kwargs)}")
        del dt  # unused, as in the reference
        hyperparam_ = dict(hyperparam or {})
        hyperparam_["param_prior_std"] = hyperparam_.get(
            "param_prior_std", self.param_prior_std)
        generator = _seeded(generator, 0)
        y = self._as_device(y)

        self.gain = torch.ones(len(y), device=self.device) \
            if gain_init is None else self._as_device(gain_init)
        self.adam_runner, opt_state_init_fun = fth.make_adam_runner(
            poisson_m_step_objective_gain, m_step_step_size,
            maxiter=m_step_maxiter, tol=m_step_tol)
        opt_state_curr = opt_state_init_fun(self.params)

        _, log_lat_l, _, log_dyn = gpk.create_transition_prob_1d(
            self.possible_latent_bin, self.possible_dynamics,
            hyperparam_.get("movement_variance", self.movement_variance),
            hyperparam_.get("p_move_to_jump", self.p_move_to_jump),
            hyperparam_.get("p_jump_to_move", self.p_jump_to_move),
        )
        self.log_latent_transition_kernel_l = log_lat_l
        self.log_dynamics_transition_kernel = log_dyn

        if ma_neuron is None:
            ma_neuron = self.ma_neuron_default
        if ma_latent is None:
            ma_latent = self.ma_latent_default
        if log_posterior_init is None:
            log_posterior_init, _ = self.init_latent_posterior(len(y),
                                                               generator)
        else:
            log_posterior_init = self._as_device(log_posterior_init)

        log_posterior_curr = log_posterior_init
        param_curr = self.params
        gain_curr = self.gain
        if save_every is None:
            save_every = n_iter

        params_saved, tuning_saved, gain_saved = [], [], []
        iter_saved, log_marginal_saved = [], []
        log_marginal_l = []
        m_step_res_l = {}
        for i in range(n_iter):
            m_step_res = self.m_step(
                param_curr, y, log_posterior_curr, self.tuning_basis,
                hyperparam_, opt_state_curr, gain_curr, host_trim=False,
            )
            param_curr = m_step_res["params"]
            gain_curr = m_step_res["gain"]
            opt_state_curr = m_step_res["opt_state"]
            tuning = m_step_res["tuning"]
            self.gain = gain_curr
            if i == 0:
                m_step_res_l = {k: [] for k in m_step_res}
            for k in m_step_res:
                if k not in ("params", "opt_state", "gain"):
                    m_step_res_l[k].append(m_step_res[k])

            (log_posterior_all, log_marginal_final, _causal, _pred, _acc,
             _ll) = self._decode_latent(
                y, tuning, hyperparam_, self.log_latent_transition_kernel_l,
                self.log_dynamics_transition_kernel, ma_neuron, ma_latent,
                likelihood_scale, n_time_per_chunk, gain_curr,
            )
            log_posterior_curr = torch.logsumexp(log_posterior_all, dim=1)
            log_marginal_l.append(log_marginal_final)
            if i % save_every == 0:
                params_saved.append(param_curr)
                tuning_saved.append(tuning)
                gain_saved.append(gain_curr)
                iter_saved.append(i)
                log_marginal_saved.append(log_marginal_final)
            if verboase:
                print(f"EM(gain) iteration {i + 1}/{n_iter}", flush=True)

        fth.batch_trim_m_step_histories(m_step_res_l)
        self.params = param_curr
        self.tuning = tuning
        self.gain = gain_curr
        self.log_marginal_final = log_marginal_final
        posterior = torch.exp(log_posterior_all)
        self.posterior_latent_marg = posterior.sum(dim=1)
        self.posterior_dynamics_marg = posterior.sum(dim=2)
        # the latent-marginal log posterior stays on the instance for
        # post-fit gain refits (reference experimental/test_exp.py:13)
        self.log_posterior = torch.log(self.posterior_latent_marg + 1e-38)
        return {
            "log_posterior_all_saved": [],
            "log_posterior_init": log_posterior_init,
            "params_saved": params_saved,
            "tuning_saved": tuning_saved,
            "gain_saved": gain_saved,
            "iter_saved": iter_saved,
            "params": self.params,
            "tuning": self.tuning,
            "gain": self.gain,
            "log_posterior_final": log_posterior_all,
            "log_marginal": log_marginal_final,
            "log_marginal_l": log_marginal_l,
            "log_marginal_saved": log_marginal_saved,
            "posterior": posterior,
            "posterior_latent_marg": self.posterior_latent_marg,
            "posterior_dynamics_marg": self.posterior_dynamics_marg,
            "m_step_res_l": m_step_res_l,
        }


def shuffle_and_decode_gain(model, spk_mat, n_shuffle=100, seed=None,
                            verbose=True, **decode_kwargs):
    """Circular-shuffle null for the gain model: each shuffle re-fits the
    gain during naive-Bayes decoding (reference experimental/test_exp.py).
    ``verbose`` prints one line per shuffle (no progress bar)."""
    from poor_man_gplvm_tpu_torch.validation import circular_shuffle_data

    decoding_res_l = []
    for i, y_sh in enumerate(circular_shuffle_data(
            spk_mat, n_shuffle=n_shuffle, seed=seed)):
        decoding_res_l.append(
            model.decode_latent_naive_bayes(y_sh, **decode_kwargs))
        if verbose:
            print(f"shuffle {i + 1}/{n_shuffle}", flush=True)

    def host(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)

    return {
        k: np.array([host(d[k]) for d in decoding_res_l])
        for k in decoding_res_l[0].keys()
    }
