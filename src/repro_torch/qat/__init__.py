"""repro_torch.qat — quantisation-aware training for the deployed numerics.

Trains exactly the model the Engine deploys: the loss forward runs eq-9
fake-quant weights (STE, ``qat.fakequant``) under a runtime Backend's LUT
execution modes — on the card, with ``backend="cuda"``, the hand-written
LUT softmax and GELU kernels behind straight-through estimators — AdamW
updates float shadow weights, and ``qat.export`` collapses the result
into a ``QuantRecipe`` + int8 params whose non-executing
``runtime.compile_model(..., backend="lut", integer_exec=False)`` logits
are bit-identical to the QAT eval path.  ``qat.distill`` adds KD from a
float KWT-1 teacher (paper §III's 35->2 retraining route).

    spec = qat.QATSpec(runtime.QuantRecipe.from_config(cfg),
                       qat.QATConfig(backend="cuda"))
    step = steps.make_train_step(cfg, shape, hp, qat=spec)
    qstate = qat.init_qat_state(spec)
    params, opt, qstate, metrics = step(params, opt, qstate, batch)
    ex = qat.export(params, spec, qstate)
    eng = runtime.compile_model(cfg, ex.params, backend="cuda",
                                recipe=ex.recipe)
"""

from repro_torch.qat.export import QATExport, eval_forward, export
from repro_torch.qat.fakequant import (calibrate_exponent, fake_quant,
                                       fake_quant_input, fake_quant_tree)
from repro_torch.qat.train import (QATConfig, QATSpec, finetune_qat,
                                   init_qat_state, make_qat_train_step,
                                   qat_params)

__all__ = ["QATConfig", "QATExport", "QATSpec", "calibrate_exponent",
           "eval_forward", "export", "fake_quant", "fake_quant_input",
           "fake_quant_tree", "finetune_qat", "init_qat_state",
           "make_qat_train_step", "qat_params"]
