"""Logging: per-run log.txt (ExperimentLogger), append-only unified
CSVs, TensorBoard scalars -- port of vae_song_tpu/train/loggers.py,
schema-compatible with the reference (utils.py:168-185, 646-762;
main.py:221,294-296). Copied; `count_params` counts a module's
parameters where the JAX version walks a parameter tree."""

import csv
import os
from datetime import datetime


def log_unified(path, list_elements, list_names, logfilename="unified_log.csv"):
    """Append-with-header CSV (utils.py:168-176)."""
    os.makedirs(path, exist_ok=True)
    full_path = os.path.join(path, logfilename)
    with open(full_path, mode="a", newline="") as f:
        writer = csv.writer(f, delimiter=",", quotechar='"', quoting=csv.QUOTE_MINIMAL)
        if f.tell() == 0:
            writer.writerow(list_names)
        writer.writerow(list_elements)


def log_unified_dict(path, dict_elements, logfilename="unified_log.csv"):
    """Dict variant (utils.py:178-185)."""
    log_unified(
        path, list(dict_elements.values()), list(dict_elements.keys()), logfilename
    )


class TensorBoardWriter:
    """TensorBoard scalar logging via the native tfevents writer
    (train/tfevents.py). If file creation itself fails (read-only dir,
    ...), a warning is printed once and logging no-ops."""

    def __init__(self, log_dir):
        self._writer = None
        try:
            from vae_song_tpu_torch.train.tfevents import EventFileWriter

            self._writer = EventFileWriter(log_dir)
        except Exception as e:
            import sys

            print(f"warning: TensorBoard event file unavailable ({e}); "
                  f"scalar logging to {log_dir} disabled", file=sys.stderr)

    def add_scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def close(self):
        if self._writer is not None:
            self._writer.close()


def count_params(module) -> int:
    """Number of parameter elements of a torch module."""
    return sum(p.numel() for p in module.parameters())


class ExperimentLogger:
    """Per-run log.txt writer (utils.py:646-762)."""

    def __init__(self, result_dir, experiment_name):
        self.result_dir = result_dir
        self.experiment_name = experiment_name
        self.log_file = os.path.join(result_dir, "log.txt")
        self.start_time = datetime.now()
        self.alpha_history = []
        os.makedirs(result_dir, exist_ok=True)
        with open(self.log_file, "w") as f:
            f.write(f"=== Experiment Log: {experiment_name} ===\n")
            f.write(f"Start Time: {self.start_time.strftime('%Y-%m-%d %H:%M:%S')}\n\n")

    def log_hyperparameters(self, **hyperparams):
        with open(self.log_file, "a") as f:
            f.write("=== Hyperparameters ===\n")
            for key, value in hyperparams.items():
                f.write(f"{key}: {value}\n")
            f.write("\n")

    def log_model_info(self, model):
        """The model's type, hyperparameters and parameter count (the JAX
        version takes the parameter tree beside the model)."""
        n = count_params(model)
        with open(self.log_file, "a") as f:
            f.write("=== Model Information ===\n")
            f.write(f"Model Type: {type(model).__name__}\n")
            if hasattr(model, "beta"):
                f.write(f"Beta: {model.beta}\n")
            if hasattr(model, "alpha"):
                f.write(f"Alpha: {model.alpha}\n")
            if hasattr(model, "inverse_lipschitz"):
                f.write(f"IL: {float(model.inverse_lipschitz)}\n")
            if hasattr(model, "latent_channel"):
                f.write(f"Latent Dimension: {model.latent_channel}\n")
            if hasattr(model, "data_type"):
                f.write(f"Data Type: {model.data_type}\n")
            if hasattr(model, "num_points"):
                f.write(f"Number of Points: {model.num_points}\n")
            f.write(f"Total Parameters: {n:,}\n")
            f.write(f"Trainable Parameters: {n:,}\n")
            f.write("\n")

    def log_alpha_value(self, epoch, alpha_value):
        self.alpha_history.append((epoch, alpha_value))

    def log_evaluation_metrics(self, au=None, kl=None, mi=None, nll=None, **other_metrics):
        with open(self.log_file, "a") as f:
            f.write("=== Evaluation Metrics ===\n")
            if au is not None:
                f.write(f"AU (Active Units): {au:.6f}\n")
            if kl is not None:
                f.write(f"KL Divergence: {kl:.6f}\n")
            if mi is not None:
                f.write(f"MI (Mutual Information): {mi:.6f}\n")
            if nll is not None:
                f.write(f"NLL (Negative Log-Likelihood): {nll:.6f}\n")
            for key, value in other_metrics.items():
                if value is None:
                    continue
                f.write(f"{key}: {value:.6f}\n")
            f.write("\n")

    def log_alpha_warmup_summary(self, wu_strat):
        if not self.alpha_history:
            return
        with open(self.log_file, "a") as f:
            f.write("=== Alpha Warmup Summary ===\n")
            f.write(f"Warmup Strategy: {wu_strat}\n")
            if wu_strat == "kl_adaptive":
                alpha_values = [a for _, a in self.alpha_history]
                avg_alpha = sum(alpha_values) / len(alpha_values)
                f.write(f"Average Alpha across epochs: {avg_alpha:.6f}\n")
                f.write(f"Final Alpha value: {alpha_values[-1]:.6f}\n")
                f.write(f"Alpha history (first 10 epochs): {self.alpha_history[:10]}\n")
                f.write(f"Alpha history (last 10 epochs): {self.alpha_history[-10:]}\n")
            else:
                f.write(f"Final Alpha value: {self.alpha_history[-1][1]:.6f}\n")
            f.write("\n")

    def finalize_log(self):
        end_time = datetime.now()
        duration = end_time - self.start_time
        with open(self.log_file, "a") as f:
            f.write("=== Experiment Summary ===\n")
            f.write(f"End Time: {end_time.strftime('%Y-%m-%d %H:%M:%S')}\n")
            f.write(f"Total Duration: {str(duration)}\n")
            f.write(f"Log saved to: {self.log_file}\n")


def create_experiment_logger(result_dir, experiment_name):
    return ExperimentLogger(result_dir, experiment_name)
