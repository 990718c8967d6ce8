from kanodes.ops import basis as basis
