// The paged attention kernels alone (attention_emu.inc: the kernel
// source with its host launchers cut off, written by the test before it
// compiles this file), so that a test can compile a mutated copy of the
// source quickly.
#include "shim.h"
#include "attention_emu.inc"
#include "attention_harness.h"
