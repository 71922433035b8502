/* Rewrites a JPEG's quantized coefficients (jpeg_read_coefficients) with
   another entropy coding (Huffman or arithmetic), restart interval,
   arithmetic-coding conditioning (DAC) and scan script, as jpegtran would.
   tests/torch_jpeg_fixtures/generate.py builds it against the system
   libjpeg at generation time:

     transcode IN OUT ARITH RESTART DAC SCANS [OPTIMIZE]

   ARITH 0 or 1; RESTART in MCUs; DAC "L,U,K" for every table, or "-";
   SCANS "-" (one sequential scan), "simple" (jpeg_simple_progression) or
   a script "c,c:Ss-Se:Ah,Al;..." of component indices; OPTIMIZE 1 writes
   optimal Huffman tables. */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

int main(int argc, char** argv) {
  if (argc < 7) {
    fprintf(stderr, "usage: %s in out arith restart dac|- scans|-|simple [optimize]\n", argv[0]);
    return 2;
  }
  struct jpeg_decompress_struct d;
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e1, e2;
  static jpeg_scan_info scans[64];
  FILE* in = fopen(argv[1], "rb");
  FILE* out = fopen(argv[2], "wb");
  if (!in || !out) return 1;
  d.err = jpeg_std_error(&e1);
  jpeg_create_decompress(&d);
  jpeg_stdio_src(&d, in);
  jpeg_read_header(&d, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&d);
  c.err = jpeg_std_error(&e2);
  jpeg_create_compress(&c);
  jpeg_stdio_dest(&c, out);
  jpeg_copy_critical_parameters(&d, &c);
  c.arith_code = atoi(argv[3]);
  c.restart_interval = atoi(argv[4]);
  if (strcmp(argv[5], "-") != 0) { /* "L,U,K" for every table */
    int l, u, k;
    sscanf(argv[5], "%d,%d,%d", &l, &u, &k);
    for (int t = 0; t < NUM_ARITH_TBLS; t++) {
      c.arith_dc_L[t] = l;
      c.arith_dc_U[t] = u;
      c.arith_ac_K[t] = k;
    }
  }
  if (strcmp(argv[6], "simple") == 0) {
    jpeg_simple_progression(&c);
  } else if (strcmp(argv[6], "-") != 0) { /* "c,c:Ss-Se:Ah,Al;..." */
    int n = 0;
    char* save;
    for (char* s = strtok_r(argv[6], ";", &save); s; s = strtok_r(NULL, ";", &save), n++) {
      char comps[32];
      int ss, se, ah, al;
      sscanf(s, "%31[^:]:%d-%d:%d,%d", comps, &ss, &se, &ah, &al);
      scans[n].comps_in_scan = 0;
      for (char* p = strtok(comps, ","); p; p = strtok(NULL, ","))
        scans[n].component_index[scans[n].comps_in_scan++] = atoi(p);
      scans[n].Ss = ss;
      scans[n].Se = se;
      scans[n].Ah = ah;
      scans[n].Al = al;
    }
    c.scan_info = scans;
    c.num_scans = n;
  }
  c.optimize_coding = argc > 7 && atoi(argv[7]);
  jpeg_write_coefficients(&c, coefs);
  jpeg_finish_compress(&c);
  jpeg_finish_decompress(&d);
  fclose(out);
  fclose(in);
  return 0;
}
