"""The plain references, one module a model family, named by the ``family``
key of a configuration's file (``configs/<config>.json``) and found by that
name.  Nothing here imports the program.

A family module provides, for a configuration ``c`` (the file's keys):

- ``dims(c)``: the sizes the harness reads, a dict with at least ``L`` (the
  layers) and ``V`` (the vocabulary the traffic draws its ids from);
- ``program_config(c)``: the fields of the program's ``ArchConfig``
  (``attn``, ``moe`` and ``ssm`` as dicts of their own config's fields);
- ``init_params(c, gen, device, dtype)``: the weights drawn from the
  ``torch.Generator`` ``gen`` on ``device``, in the layout the program
  takes;
- ``forward(params, c, tokens, prompt_len, prec)``: the logits [T, V] in
  float32 of one sequence, a prompt of ``prompt_len`` tokens and then the
  tokens fed back one decode step each, its products in ``prec`` (``"f32"``
  or the control's ``"fp8"``, ``common.PRECISIONS``);
- ``prefill_flops(c, n)`` and ``decode_flops(c, positions)``: the
  operations of a prefill of ``n`` tokens and of a decode step of the rows at
  ``positions``;
- ``k1_work(c, n)`` where the family's prefill runs K1 (flash attention),
  and ``k2_work(c, keys_per_row)`` where its decode runs K2 (flash decode):
  the (bytes, operations) of one layer's call.  A family without one of
  them leaves that kernel's roofline out of its cells' results.

A new family is a new module here and a configuration file that names it;
no file of the harness changes.
"""
