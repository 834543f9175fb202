"""Training losses over the renderer's output dict: the PyTorch version of
the JAX package's `train/losses.py`.

Every subset rule is a mask-weighted sum, as there: the subset depth loss
`scaling * mean_over_applied(w * (pred - target)^2)` with
`scaling = n_applied / n_batch` is evaluated as the equal
`sum(w * (pred - target)^2 * mask) / n_batch`, and the cross entropy ignores
labels < 0. Every loss returns (total, dict of terms) under the JAX
package's term names ("coarse_color", "coarse_sc_term2", "coarse_ds",
"coarse_ss", ...).
"""

import torch

from ..config import LossConfig

_EPS_GNLL = 1e-6  # torch.nn.GaussianNLLLoss eps


def _mse(a, b):
    return torch.mean((a - b) ** 2)


def _pass_result(results, typ):
    return {k[: -len(typ) - 1]: v for k, v in results.items()
            if k.endswith(f"_{typ}")}


def solar_correction_terms(result, lambda_sc):
    """Shadow-NeRF solar terms 2 and 3 of one pass: weights_sc (R,S),
    transparency_sc (R,S) and sun_sc (R,S,1) of the pass along the sun
    direction; the weights and transparency are held constant."""
    sun_sc = result["sun_sc"][..., 0]
    trans = result["transparency_sc"].detach()
    weights = result["weights_sc"].detach()
    term2 = torch.sum((trans - sun_sc) ** 2, dim=-1)
    term3 = 1.0 - torch.sum(weights * sun_sc, dim=-1)
    return (lambda_sc / 3.0 * torch.mean(term2),
            lambda_sc / 3.0 * torch.mean(term3))


def snerf_loss(results, target_rgb, lc: LossConfig):
    """RGB MSE plus the solar terms when sc_lambda > 0, coarse then fine."""
    loss_dict = {}
    for typ in ("coarse", "fine"):
        if f"rgb_{typ}" not in results:
            continue
        pass_result = _pass_result(results, typ)
        loss_dict[f"{typ}_color"] = _mse(pass_result["rgb"], target_rgb)
        if lc.sc_lambda > 0:
            t2, t3 = solar_correction_terms(pass_result, lc.sc_lambda)
            loss_dict[f"{typ}_sc_term2"] = t2
            loss_dict[f"{typ}_sc_term3"] = t3
    return sum(loss_dict.values()), loss_dict


def satnerf_loss(results, target_rgb, lc: LossConfig, beta_min=0.05):
    """Beta-uncertainty colour loss, log-beta regulariser, solar terms.

    Each pass composites its own beta, where the original indexed
    `beta_coarse` for both passes (a shape error whenever a fine pass adds
    samples); the two agree in every configuration that runs."""
    loss_dict = {}
    for typ in ("coarse", "fine"):
        if f"rgb_{typ}" not in results:
            continue
        pass_result = _pass_result(results, typ)
        weights = pass_result["weights"]
        beta_per_sample = results.get(f"beta_{typ}", results["beta_coarse"])
        beta = torch.sum(weights[..., None] * beta_per_sample, dim=-2) + beta_min
        loss_dict[f"{typ}_color"] = torch.mean(
            (pass_result["rgb"] - target_rgb) ** 2 / (2.0 * beta ** 2))
        loss_dict[f"{typ}_logbeta"] = (3.0 + torch.mean(torch.log(beta))) / 2.0
        if lc.sc_lambda > 0:
            t2, t3 = solar_correction_terms(pass_result, lc.sc_lambda)
            loss_dict[f"{typ}_sc_term2"] = t2
            loss_dict[f"{typ}_sc_term3"] = t3
    return sum(loss_dict.values()), loss_dict


def _pred_depth_std(z_vals, pred_depth, pred_weights):
    """sqrt(sum(w * (z - d)^2)), the spread of a ray's depth distribution.
    The sum is floored before the sqrt: a fully transparent ray would give
    sqrt(0), whose gradient is NaN even under a zero cotangent."""
    return torch.sqrt(torch.clamp_min(
        torch.sum((z_vals - pred_depth[:, None]) ** 2 * pred_weights, dim=-1),
        1e-12))


def depth_loss(results, target_depth, target_weight, valid_depth, target_std,
               lc: LossConfig):
    """Stereo-depth supervision. target_depth, target_weight, target_std:
    (R,); valid_depth: (R,) 0/1.

    usealldepth and MSE: lambda/3 * mean(w * (d_pred - d_t)^2) over all rays.
    Otherwise only rays that are valid and, unless usealldepth, fail the
    expected-distribution test (|d_pred - d_t| > std_t or std_pred > std_t)
    contribute, as a masked sum over R. GNLL passes the predicted std where
    torch's GaussianNLLLoss expects a variance, as the original does."""
    loss_dict = {}
    n_rays = target_depth.shape[0]
    lam = lc.ds_lambda / 3.0
    valid = valid_depth > 0
    for typ in ("coarse", "fine"):
        if f"depth_{typ}" not in results:
            continue
        pred_depth = results[f"depth_{typ}"]
        if lc.usealldepth and not lc.gnll:
            loss_dict[f"{typ}_ds"] = lam * torch.mean(
                target_weight * (pred_depth - target_depth) ** 2)
            continue
        pred_std = _pred_depth_std(results[f"z_vals_{typ}"], pred_depth,
                                   results[f"weights_{typ}"])
        if lc.usealldepth:
            apply_mask = valid
        else:
            off_distribution = ((pred_depth - target_depth).abs() > target_std) \
                | (pred_std > target_std)
            apply_mask = valid & off_distribution
        maskf = apply_mask.to(pred_depth.dtype)
        if lc.gnll:
            var = torch.clamp_min(pred_std, _EPS_GNLL)
            nll = 0.5 * (torch.log(var) + (pred_depth - target_depth) ** 2 / var)
            loss_dict[f"{typ}_ds"] = lam * torch.sum(nll * maskf) / n_rays
        else:
            sq = target_weight * (pred_depth - target_depth) ** 2
            loss_dict[f"{typ}_ds"] = lam * torch.sum(sq * maskf) / n_rays
    total = sum(loss_dict.values()) if loss_dict else torch.tensor(0.0)
    return total, loss_dict


def semantic_loss(results, target_labels, lc: LossConfig):
    """Cross entropy of the mean-pooled per-ray logits; labels < 0 are
    ignored and the mean is over the other rays. target_labels: (R,) ints,
    -100 for void."""
    loss_dict = {}
    labels = target_labels.long()
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    maskf = valid.float()
    denom = torch.clamp_min(torch.sum(maskf), 1.0)
    for typ in ("coarse", "fine"):
        if f"sem_logits_{typ}" not in results:
            continue
        logp = torch.log_softmax(results[f"sem_logits_{typ}"].float(), dim=-1)
        nll = -torch.gather(logp, 1, safe[:, None])[:, 0]
        loss_dict[f"{typ}_ss"] = lc.ss_lambda * torch.sum(nll * maskf) / denom
    total = sum(loss_dict.values()) if loss_dict else torch.tensor(0.0)
    return total, loss_dict


def total_loss(results, batch, lc: LossConfig, step, ds_drop_step,
               ss_drop_step, use_beta_loss=False):
    """The training objective: colour (SatNeRF with beta once use_beta_loss,
    else SNeRF) plus depth until ds_drop_step and semantics until
    ss_drop_step.

    batch: rgbs (R,3) and, when enabled, depths (R,2) [depth, weight],
    valid_depth (R,), depth_std (R,), sems (R,). With lc.beta the term dict
    holds the keys of both colour losses, those of the unused one as 0."""
    if lc.beta:
        base_beta, dict_beta = satnerf_loss(results, batch["rgbs"], lc)
        base_plain, dict_plain = snerf_loss(results, batch["rgbs"], lc)
        use, other = ((base_beta, dict_beta), dict_plain) if use_beta_loss \
            else ((base_plain, dict_plain), dict_beta)
        base, loss_dict = use[0], dict(use[1])
        zero = torch.zeros((), device=base.device)
        for k in other:
            loss_dict.setdefault(k, zero)
    else:
        base, loss_dict = snerf_loss(results, batch["rgbs"], lc)

    total = base
    if lc.depth and lc.ds_lambda > 0:
        d_loss, d_dict = depth_loss(results, batch["depths"][:, 0],
                                    batch["depths"][:, 1],
                                    batch["valid_depth"], batch["depth_std"],
                                    lc)
        if step < ds_drop_step:
            total = total + d_loss
        loss_dict.update(d_dict)
    if lc.sem:
        s_loss, s_dict = semantic_loss(results, batch["sems"], lc)
        if step < ss_drop_step:
            total = total + s_loss
        loss_dict.update(s_dict)
    return total, loss_dict
