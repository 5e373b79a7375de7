"""How far float32 rounding moves a MarrNet-1 gradient, in each package.

One train-mode gradient of MarrNet-1's loss (64² procedural scenes, batch
4, no augmentation, the JAX model's seeded init) computed four ways: the
port in float32 and float64, the JAX package in float32 and float64 (its
module cloned to that dtype).  Prints, over every parameter tensor whose
gradient is above 1e-6 of the largest, the worst distance of the norm
ratio from 1 and the smallest cosine of each pair.  Runs on the CPU:

  python tools/probe_grad_precision.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("GENRE_PROCEDURAL_CACHE", "")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from genre_shapehd_tpu.core.registry import get_model as jax_model
    from genre_shapehd_tpu.data.loader import collate
    from genre_shapehd_tpu.data.procedural import Dataset
    from genre_shapehd_tpu.models.base import default_opt as jax_opt
    from genre_shapehd_tpu_torch.core.convert import jax_to_torch
    from genre_shapehd_tpu_torch.core.registry import get_model
    from genre_shapehd_tpu_torch.models.base import default_opt, masked_mse

    dims = dict(im_size=64, vox_res=32, sph_res=32, z_res=64,
                no_aug=True, procedural_length=8)
    jm = jax_model("marrnet1")(jax_opt(**dims))
    state = jm.init_state(jax.random.PRNGKey(0))
    ds = Dataset(jm.opt, "train", model=jm)
    batch = {k: v for k, v in collate([ds[i] for i in range(4)]).items()
             if isinstance(v, np.ndarray)}
    params = jax.tree.map(np.asarray, state.params["net"])
    stats = jax.tree.map(np.asarray, state.batch_stats["net"])

    def jax_grads(dtype):
        cast = lambda t: jax.tree.map(                       # noqa: E731
            lambda x: jnp.asarray(x, dtype), t)
        jm.net = jm.net.clone(dtype=dtype)
        grad = jax.jit(jax.grad(jm._loss, has_aux=True), static_argnums=3)
        g, _ = grad(cast(params), cast(stats), cast(batch), True)
        return {k: v.double() for k, v in jax_to_torch(
            jax.tree.map(lambda x: np.asarray(x, np.float64), g),
            {}).items()}

    def port_grads(dtype):
        tm = get_model("marrnet1")(default_opt(device="cpu", **dims))
        tm.load_weights(params, stats)
        net = tm.net.to(dtype).train()
        b = {k: torch.as_tensor(v, dtype=dtype) for k, v in batch.items()}
        pred = net(b["rgb"])
        fg = (b["silhou"] != 0).to(dtype)
        loss = (masked_mse(pred["normal"], b["normal"], fg)
                + masked_mse(pred["depth"], b["depth"], fg)
                + ((pred["silhou"] - b["silhou"]) ** 2).mean())
        loss.backward()
        return {n: p.grad.double() for n, p in net.named_parameters()}

    port32, port64 = port_grads(torch.float32), port_grads(torch.float64)
    with jax.enable_x64():
        jax64 = jax_grads(jnp.float64)
    jax32 = jax_grads(jnp.float32)
    big = max(float(v.norm()) for v in port64.values())
    keys = [k for k, v in port64.items() if float(v.norm()) > 1e-6 * big]

    def worst(a, b):
        ratio = max(abs(float(a[k].norm() / b[k].norm()) - 1) for k in keys)
        cos = min(float(a[k].flatten() @ b[k].flatten()
                        / (a[k].norm() * b[k].norm())) for k in keys)
        return ratio, cos

    for name, a, b in (("JAX float64 vs port float64", jax64, port64),
                       ("port float32 vs port float64", port32, port64),
                       ("JAX float32 vs JAX float64", jax32, jax64),
                       ("port float32 vs JAX float32", port32, jax32),
                       ("port float32 vs JAX float64", port32, jax64)):
        ratio, cos = worst(a, b)
        print(f"{name}: worst norm ratio error {ratio:.3g}, "
              f"smallest cosine {cos:.7f} ({len(keys)} tensors)")


if __name__ == "__main__":
    main()
