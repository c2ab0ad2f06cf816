"""Offline dataset preprocessing (reference offline_preprocessing/*).

Counterpart of the JAX package's ``preprocessing/``: run-once steps that write
the on-disk layout the loader reads, ``features/<class>/*.npy`` +
``splits.npy`` + ``norm_stats/glob_norm.npy``, from class-foldered raw
audio. The log-mel is the offline ``MelSpec`` (Slaney scale and norm,
20/power*log10), K3 on the card; ``audio_io`` also serves the raw-audio
predict path.
"""

from audio_few_shot_learning_tpu_torch.preprocessing.audio_io import load_audio  # noqa: F401
from audio_few_shot_learning_tpu_torch.preprocessing.make_splits import (  # noqa: F401
    REFERENCE_SPLIT_COUNTS,
    compute_waveform_norm,
    make_splits,
)
from audio_few_shot_learning_tpu_torch.preprocessing.norm_stats import compute_global_norm  # noqa: F401
from audio_few_shot_learning_tpu_torch.preprocessing.to_np_and_norm import (  # noqa: F401
    normalise,
    wav_dir_to_npy,
)
from audio_few_shot_learning_tpu_torch.preprocessing.to_spec import npy_dir_to_spec  # noqa: F401
from audio_few_shot_learning_tpu_torch.preprocessing.to_var_spec import (  # noqa: F401
    npy_dir_to_var_spec,
    stacked_spec,
    variable_splits,
)
