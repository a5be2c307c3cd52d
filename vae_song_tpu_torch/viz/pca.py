"""PCA / t-SNE latent visualizations (port of vae_song_tpu/viz/pca.py,
utils.py:195-424). matplotlib is imported inside each plotting function
and scikit-learn inside the t-SNE step, so the module imports without
either; a plot raises ImportError without matplotlib, and t-SNE prints its
error and is skipped without scikit-learn, as in JAX. t-SNE runs on one
OpenMP thread (JAX's runs on all)."""

import os

import numpy as np

from vae_song_tpu_torch.viz.plots import _np, _pyplot


def pca_calculation(x):
    """Hand-rolled eigh PCA (utils.py:195-213): (x_pca, its min, its max,
    min of x, max of x)."""
    x = _np(x)
    x_mean = np.mean(x, axis=0)
    x_centered = x - x_mean
    cov = x_centered.T @ x_centered / (x_centered.shape[0] - 1)
    eigenvalues, eigenvectors = np.linalg.eigh(cov)
    order = np.argsort(eigenvalues)[::-1]
    eigenvectors = eigenvectors[:, order]
    x_pca = x_centered @ eigenvectors
    return x_pca, x_pca.min(), x_pca.max(), x.min(), x.max()


def pca_plot(x, x_pca, x_pca_min, x_pca_max, x_min, x_max, v_min, v_max, y,
             epoch, resultname, name, variablename="?", var=None, cmapc="viridis",
             root=".", run_tsne=True):
    """Per-component strip plots, the 2-D PCA scatter and t-SNE
    (utils.py:216-268) under `<root>/results/<resultname>/<name>/pca/`."""
    plt = _pyplot()
    outdir = os.path.join(root, "results", resultname, name, "pca")
    os.makedirs(outdir, exist_ok=True)
    if var is None:
        var = np.zeros_like(x)

    max_iter = 32
    zero = np.zeros_like(x_pca[:, 0])
    num_components = min(x_pca.shape[1], max_iter)
    if num_components > 1:
        fig, axes = plt.subplots(num_components, 1, figsize=(15, 10), sharex=True)
        for i in range(num_components):
            axes[i].scatter(x_pca[:, i], zero, c=var[:, i], cmap=cmapc, vmin=0, vmax=1.0,
                            marker="|")
            axes[i].get_yaxis().set_visible(False)
            axes[i].set_xlim([x_pca_min, x_pca_max])
        plt.savefig(os.path.join(outdir, f"{epoch}_pca_all_{variablename}.png"))
        plt.close(fig)

        fig, axes = plt.subplots(min(x.shape[1], max_iter), 1, figsize=(15, 10), sharex=True)
        for i in range(min(x.shape[1], max_iter)):
            axes[i].scatter(x[:, i], zero, c=var[:, i], cmap=cmapc, vmin=v_min, vmax=v_max,
                            marker="|")
            axes[i].get_yaxis().set_visible(False)
            axes[i].set_xlim([x_min, x_max])
        plt.savefig(os.path.join(outdir, f"{epoch}_channels_all_{variablename}.png"))
        plt.close(fig)

    plt.figure(figsize=(10, 8))
    sc = plt.scatter(x_pca[:, 0], x_pca[:, min(1, x_pca.shape[1] - 1)],
                     c=var.max(1), cmap=cmapc, vmin=v_min, vmax=v_max)
    plt.colorbar(sc, label="Maximum Variance")
    plt.savefig(os.path.join(outdir, f"{epoch}_pca_v_{variablename}.png"))
    plt.close()

    if run_tsne:
        try:
            from sklearn.manifold import TSNE
            from threadpoolctl import threadpool_limits

            # one OpenMP thread: on a host whose cores are busy, t-SNE's
            # spinning OpenMP threads took 166 s for what one thread does
            # in 5.4 s (1000 points; 3.5 s with all 8 threads when idle)
            with threadpool_limits(1):
                mu_tsne = TSNE(n_components=2, random_state=0).fit_transform(x)
            plt.figure(figsize=(10, 8))
            sc = plt.scatter(mu_tsne[:, 0], mu_tsne[:, 1], c=y, cmap="tab10")
            plt.colorbar(sc, label="Class")
            plt.xlim([-50, 50])
            plt.ylim([-50, 50])
            plt.savefig(os.path.join(outdir, f"{epoch}_tsne_c.png"))
            plt.close()
        except Exception as e:  # noqa: BLE001 -- t-SNE failing is not fatal, as in JAX
            print(f"Error in tsne: {e}")


def rec_lr_scatter_visualization(results_root, dataset_name, load_and_eval_fn,
                                 output_path=None):
    """Walk a results tree for final checkpoints and scatter the
    reconstruction loss against the latent-reconstruction loss of each
    run, log-log (utils.py:324-424). load_and_eval_fn(model_path, run_key)
    -> (loss_rec, loss_lr) or None. Directory contract:
    results/result_<key>_..._<dataset>/<run name>/params/model_*.pkl."""
    plt = _pyplot()
    l_rec, l_lr, colors, labels, color_labels = [], [], [], [], []
    count = 0
    for root, _dirs, files in os.walk(results_root):
        for file in files:
            if not (file.startswith("model_") and file.endswith(".pkl")):
                continue
            if root.find(dataset_name) == -1:
                continue
            parts = root.replace("\\", "/").split("/")
            key = next((p.split("_")[1] for p in parts if p.startswith("result_")), None)
            run_label = parts[-2] if parts[-1] == "params" else parts[-1]
            out = load_and_eval_fn(os.path.join(root, file), key)
            if out is None:
                continue
            rec, lr = out
            l_rec.append(float(rec))
            l_lr.append(float(lr))
            labels.append(run_label)
            base = run_label.split(" ")[0]
            if base not in color_labels:
                color_labels.append(base)
            colors.append(color_labels.index(base))
            count += 1

    plt.figure(figsize=(10, 8))
    plt.title("Reconstruction Loss vs Latent Reconstruction Loss:" + dataset_name)
    plt.scatter(l_lr, l_rec, c=colors, cmap="tab10")
    for i, label_name in enumerate(labels):
        plt.annotate(label_name, (l_lr[i], l_rec[i]), fontsize=8, alpha=0.7)
    plt.yscale("log")
    plt.xscale("log")
    plt.xlabel("Latent Reconstruction Loss")
    plt.ylabel("Reconstruction Loss")
    output_path = output_path or os.path.join(results_root, "rec_scatter",
                                              "loss_scatter_plot.png")
    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    plt.savefig(output_path)
    plt.close()
    print(count, "points plotted")
    return output_path


def pca_visualization(encode_fn, X, y, eps, epoch, name, resultname, root=".",
                      max_samples=1000, run_tsne=True):
    """PCA/t-SNE of the posterior mu and of z = mu + eps * exp(log_var / 2)
    (utils.py:271-317). encode_fn(X) -> (mu, log_var); X and y numpy (their
    first `max_samples`); eps [len(X), latent], the noise JAX draws from its
    PRNG, given here."""
    X = _np(X)[:max_samples]
    y = _np(y)[:max_samples]
    mu, log_var = encode_fn(X)
    mu = _np(mu)
    var = np.exp(_np(log_var))
    z = mu + _np(eps) * np.sqrt(var)

    v_min, v_max = var.min(), var.max()
    mu_pca, mu_pca_min, mu_pca_max, mu_min, mu_max = pca_calculation(mu)
    z_pca, z_pca_min, z_pca_max, z_min, z_max = pca_calculation(z)

    if epoch == 0:
        plt = _pyplot()
        outdir = os.path.join(root, "results", resultname, name, "pca")
        os.makedirs(outdir, exist_ok=True)
        zpz = np.random.randn(*mu.shape)
        zpz_pca, *_ = pca_calculation(zpz)
        plt.figure(figsize=(10, 8))
        plt.scatter(zpz_pca[:, 0], zpz_pca[:, min(1, zpz_pca.shape[1] - 1)],
                    c=var.mean(1), cmap="coolwarm", vmin=0, vmax=1.0)
        plt.savefig(os.path.join(outdir, "prior.png"))
        plt.close()

    pca_plot(mu, mu_pca, mu_pca_min, mu_pca_max, mu_min, mu_max, v_min, v_max,
             y, epoch, resultname, name, variablename="mu", var=var, root=root,
             run_tsne=run_tsne)
    pca_plot(z, z_pca, z_pca_min, z_pca_max, z_min, z_max, v_min, v_max,
             y, epoch, resultname, name, variablename="z", var=np.zeros_like(mu),
             cmapc="coolwarm", root=root, run_tsne=run_tsne)
