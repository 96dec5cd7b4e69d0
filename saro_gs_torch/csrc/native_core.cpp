/* The core host library's COLMAP parser and its own two functions.
 *
 * saro_gs_torch/native.py builds this file and native/src/knn.cpp into a
 * library of its own that needs no libpng or libjpeg (their headers are
 * not on every host), and native/src/image.cpp alone into the image
 * library.  This file compiles native/src/colmap_bin.cpp as it is, with
 * one change of call: the parser skips each record's track with
 * fseek(f, n, SEEK_CUR), and glibc's fseek makes an lseek system call
 * every time, even where the target lies in the stream's buffer (it
 * resyncs the kernel's offset).  That is one system call a 3D point; on a
 * host where system calls are slow it made the native parse slower than
 * the Python one.  A short forward skip is read through the buffer
 * instead; any other seek is fseek's.
 *
 * It also defines sn_free and sn_version as native/src/image.cpp does for
 * the whole library.  Both libraries export these two symbols; each is
 * loaded on its own handle, so neither sees the other's.
 */
#include <cstdio>
#include <cstdlib>

namespace {

int skip_forward(FILE *f, long offset, int whence) {
  if (whence != SEEK_CUR || offset < 0 || offset > (1L << 20))
    return fseek(f, offset, whence);
  char scratch[4096];
  while (offset > 0) {
    size_t n = offset < (long)sizeof(scratch) ? (size_t)offset
                                              : sizeof(scratch);
    if (fread(scratch, 1, n, f) != n) return -1;
    offset -= (long)n;
  }
  return 0;
}

}  // namespace

#define fseek skip_forward
#include "colmap_bin.cpp"
#undef fseek

extern "C" void sn_free(void *p) { free(p); }

extern "C" const char *sn_version(void) { return "saro_native 0.1.0"; }
